"""Feed-forward block: SwiGLU, GeGLU and the plain GELU MLP (counterpart
of ``repro.models.mlp``; GELU is the tanh approximation, as there)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, linear

_KINDS = ("swiglu", "geglu", "gelu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype):
    if kind not in _KINDS:
        raise ValueError(kind)
    p = {}
    if kind != "gelu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    p["w_up"] = dense_init(gen, (d_model, d_ff), dtype)
    p["w_down"] = dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff)
    return p


def mlp_fwd(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = linear(x, params["w_up"])
    if kind == "swiglu":
        act = F.silu(linear(x, params["w_gate"])) * up
    elif kind == "geglu":
        act = F.gelu(linear(x, params["w_gate"]), approximate="tanh") * up
    elif kind == "gelu":
        act = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(kind)
    return linear(act, params["w_down"])
