"""Feed-forward block: SwiGLU (counterpart of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, linear


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype):
    if kind != "swiglu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    return {"w_gate": dense_init(gen, (d_model, d_ff), dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff)}


def mlp_fwd(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    up = linear(x, params["w_up"])
    act = F.silu(linear(x, params["w_gate"])) * up
    return linear(act, params["w_down"])
