"""Tree checkpointing on np.savez (no external deps).

Counterpart of ``repro.checkpoint.checkpoint``, in its file format: one
``.npz`` per checkpoint with flattened path->array entries (path parts
joined by ``::``) plus a metadata json.  bfloat16 is not a NumPy dtype:
a bf16 leaf is stored as its bits in uint16 and its key listed under
``bf16_keys`` in the metadata.  Either package reads the other's files
for a tree of the same layout.  Restores to the exemplar tree's
structure, dtypes and devices.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_map_with_path

_SEP = "::"


def _host(x) -> np.ndarray:
    """A leaf as a NumPy array; a bf16 tensor as its bits in uint16."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: Any) -> dict:
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(p.replace("/", _SEP),
                                                    (x, _host(x))), tree)
    return out


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    flat = _flatten(tree)
    tagged = {k: arr for k, (_, arr) in flat.items()}
    bf16_keys = [k for k, (x, _) in flat.items()
                 if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16]
    np.savez(fname, **tagged)
    meta = dict(metadata or {})
    meta.update({"step": step, "bf16_keys": bf16_keys})
    with open(fname + ".json", "w") as f:
        json.dump(meta, f)
    return fname


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    cks = sorted(f for f in os.listdir(path)
                 if re.match(r"ckpt_\d+\.npz$", f))
    return os.path.join(path, cks[-1]) if cks else None


def restore_checkpoint(fname: str, exemplar: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``exemplar``: a tree of tensors,
    whose dtypes and devices the restored leaves take."""
    with open(fname + ".json") as f:
        meta = json.load(f)
    bf16 = set(meta.get("bf16_keys", []))

    with np.load(fname) as data:
        def fn(path, x):
            key = path.replace("/", _SEP)
            arr = data[key]
            if key in bf16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if tuple(t.shape) != tuple(x.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}"
                                 f", exemplar {tuple(x.shape)}")
            return t.to(x.device, x.dtype)

        return tree_map_with_path(fn, exemplar), meta
