"""The benchmark's weights, drawn from the run's seed on the device.

A reference family gives the layout (``param_layout``): a nested dict of
leaves ``(shape, init, fan_in)``.  Every leaf (the matrices, the
embedding, the norm scales) is a view into one buffer in the served
type, drawn with a few ``normal_`` calls of a ``torch.Generator`` on the
device and scaled in place per leaf.  The same seed gives the same
weights.  Inits:

- ``dense``: N(0, 1) / sqrt(fan_in);  ``embed``: N(0, 0.02^2);
- ``norm``: N(0, 0.1^2), a norm's offset from a scale of one.

``fill(tree, layout, seed)`` draws into existing leaves in place, so a
built serving stack (its captured graphs hold the leaves' addresses)
can be served with the weights of another seed.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

ALIGN = 128                     # elements: every leaf starts 256-byte aligned
CHUNK = 1 << 28                 # elements per normal_ call


def _leaves(layout, path=()) -> List[Tuple[tuple, tuple]]:
    if isinstance(layout, dict):
        return [leaf for k, v in layout.items() for leaf in _leaves(v, path + (k,))]
    if isinstance(layout, list):
        return [leaf for i, v in enumerate(layout) for leaf in _leaves(v, path + (i,))]
    return [(path, layout)]


def _build(layout, make: Callable):
    if isinstance(layout, dict):
        return {k: _build(v, make) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_build(v, make) for v in layout]
    return make(layout)


def _offsets(leaves) -> Tuple[Dict[tuple, int], int]:
    off, pos = {}, 0
    for path, (shape, _, _) in leaves:
        off[path] = pos
        pos += -(-math.prod(shape) // ALIGN) * ALIGN
    return off, pos


def allocate(layout, dtype: torch.dtype, device) -> dict:
    """Empty leaves of ``layout`` as views into one flat buffer."""
    leaves = _leaves(layout)
    off, n = _offsets(leaves)
    served = torch.empty(n, dtype=dtype, device=device)
    it = iter(leaves)

    def make(leaf):
        path, (shape, _, _) = next(it)
        return served[off[path]:off[path] + math.prod(shape)].view(shape)

    tree = _build(layout, make)
    tree["_buffers"] = (served,)
    return tree


@torch.no_grad()
def fill(tree: dict, layout, seed: int) -> None:
    """Draw every leaf of ``tree`` (made by ``allocate``) from ``seed``."""
    served, = tree["_buffers"]
    gen = torch.Generator(device=served.device).manual_seed(int(seed))
    for i in range(0, served.numel(), CHUNK):
        served[i:i + CHUNK].normal_(generator=gen)
    node_of = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                if k != "_buffers":
                    walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            node_of[path] = t

    walk(tree)
    for path, (shape, init, fan_in) in _leaves(layout):
        w = node_of[path]
        if init == "dense":
            w.mul_(1.0 / math.sqrt(max(fan_in, 1)))
        elif init == "embed":
            w.mul_(0.02)
        elif init == "norm":
            w.mul_(0.1)
        else:
            raise ValueError(f"unknown init {init!r}")


def draw(layout, seed: int, dtype: torch.dtype, device) -> dict:
    """``allocate`` then ``fill``: the weights of ``seed``."""
    tree = allocate(layout, dtype, device)
    fill(tree, layout, seed)
    return tree


def program_params(tree: dict) -> dict:
    """The tree without its flat buffers: what the program is handed."""
    return {k: v for k, v in tree.items() if k != "_buffers"}
