"""Plain reference of the ``swa+mlp`` stack (h2o-danube-1.8b), in f32.

The program's block equations (``repro_torch.models``), as the
benchmark's configuration file states them: token embedding; per layer
``x += Attn(RMSNorm(x))`` then ``x += SwiGLU(RMSNorm(x))``, where Attn is
grouped-query attention with split-halves RoPE over the last
``window_size`` positions; the final RMSNorm and an untied output head.
RMSNorm scales by ``1 + scale``.  Departures from the published model:
none in these equations; the weights are random (drawn by the benchmark
from its seed), and the program serves a prompt right-padded with id 0
to its bucket, which the benchmark hands to this reference as the
prompt.
"""
from __future__ import annotations

import torch

from perfbench.reference import common as c


def param_layout(m: dict) -> dict:
    """Every weight as ``(shape, init, fan_in)`` in the program's layout."""
    layer = {"norm1": ((m["d_model"],), "norm", 0),
             "attn": c.attention_layout(m),
             "norm2": ((m["d_model"],), "norm", 0),
             "mlp": c.mlp_layout(m)}
    out = c.embed_layout(m)
    out["layers"] = [layer] * m["num_layers"]
    return out


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, rows: torch.Tensor, m: dict,
           precision: str = "f32") -> torch.Tensor:
    """Logits (len(rows), vocab) at positions ``rows`` of the sequence
    ``tokens`` (S,), computed over the whole sequence with no cache."""
    x = params["embed"][tokens].float()
    for p in params["layers"]:
        h = c.rms_norm(x, p["norm1"], m["norm_eps"])
        x = x + c.attention(p["attn"], h, m, m["window_size"], precision)
        h = c.rms_norm(x, p["norm2"], m["norm_eps"])
        x = x + c.mlp(p["mlp"], h, m["mlp_kind"], precision)
    return c.head_logits(params, x[rows], m, precision)
