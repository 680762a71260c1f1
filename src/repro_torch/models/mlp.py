"""Feed-forward block: SwiGLU and GeGLU (counterpart of
``repro.models.mlp``; its plain ``gelu`` waits for whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, linear

_GATED = ("swiglu", "geglu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype):
    if kind not in _GATED:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    return {"w_gate": dense_init(gen, (d_model, d_ff), dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff)}


def mlp_fwd(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind not in _GATED:
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    up = linear(x, params["w_up"])
    gate = linear(x, params["w_gate"])
    if kind == "swiglu":
        act = F.silu(gate) * up
    else:
        act = F.gelu(gate, approximate="tanh") * up
    return linear(act, params["w_down"])
