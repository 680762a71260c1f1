"""Feed-forward block: SwiGLU, GeGLU and the plain GELU MLP (counterpart
of ``repro.models.mlp``; GELU is the tanh approximation, as there), and
``geglu_erf``, GeGLU with the exact erf GELU (published Zamba2's, which
the reference does not have).  The gate of a gated kind is
``glu_gate_plain``, or under ``fused`` (the decode step's kernel route,
``transformer.fused_decode``) the ``glu_gate`` kernel, and the weight
products there ``decode_linear``'s ``decode_gemm``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.glu_gate.ops import glu_gate, glu_gate_plain
from repro_torch.models.common import decode_linear, dense_init

_KINDS = ("swiglu", "geglu", "geglu_erf", "gelu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, dtype):
    if kind not in _KINDS:
        raise ValueError(kind)
    p = {}
    if kind != "gelu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype)
    p["w_up"] = dense_init(gen, (d_model, d_ff), dtype)
    p["w_down"] = dense_init(gen, (d_ff, d_model), dtype, fan_in=d_ff)
    return p


def mlp_fwd(params, x: torch.Tensor, kind: str, fused: bool = False
            ) -> torch.Tensor:
    up = decode_linear(x, params["w_up"], fused=fused)
    if kind == "gelu":
        act = F.gelu(up, approximate="tanh")
    elif kind in _KINDS:
        gate = glu_gate if fused else glu_gate_plain
        act = gate(decode_linear(x, params["w_gate"], fused=fused), up, kind)
    else:
        raise ValueError(kind)
    return decode_linear(act, params["w_down"], fused=fused)
