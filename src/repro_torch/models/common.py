"""Shared numeric helpers (plain functions on tensors, dict params).

Counterpart of ``repro.models.common``: the same numerics in PyTorch.
Weights keep JAX's ``(in, out)`` layout, so ``params_from_jax`` copies
them without a transpose.  Initialisers draw from an explicit
``torch.Generator`` (they cannot reproduce ``jax.random``'s numbers;
parity tests load the reference's weights instead).
"""
from __future__ import annotations

import numpy as np
import torch

# the plain halves of the decode step's fused kernels, which live there
from repro_torch.kernels.add_rms_norm.ops import rms_norm  # noqa: F401
from repro_torch.kernels.decode_gemm.ops import decode_gemm, takes_kernel
from repro_torch.kernels.rope_kv_write.ops import (apply_rope,  # noqa: F401
                                                   freqs_on, rope_freqs)


def to_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape, dtype, fan_in: int | None = None
               ) -> torch.Tensor:
    """Truncated-normal init in [-2, 2] scaled by 1/sqrt(fan_in), drawn
    on the generator's device.  The draw is scaled in place, so a tensor
    costs its f32 draw and its result beside each other, no more."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def keep_in(out, name: str, value: torch.Tensor) -> torch.Tensor:
    """``value`` written into ``out[name]`` in place (a layer's view into
    the decode cache), or ``value`` itself when ``out`` is None."""
    if out is None:
        return value
    return out[name].copy_(value)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with w in (in, out) layout.  The product accumulates in f32
    and rounds once to x's dtype, as the reference's
    ``preferred_element_type=f32`` then cast: f32 inputs stay f32, and
    bf16 products accumulate in f32 in PyTorch's CPU and cuBLAS GEMMs."""
    return torch.matmul(x, w)


def decode_linear(x: torch.Tensor, *ws: torch.Tensor, fused: bool = False):
    """``linear(x, w)`` for each weight of ``ws`` at a decode step.  On
    ``transformer.fused_decode``'s route (``fused``: bf16 on the card, no
    mesh) a product of at most 16 rows that the kernel takes
    (``decode_gemm.ops.takes_kernel``) is the ``decode_gemm`` kernel,
    every weight of ``ws`` in one launch (they read the same ``x``);
    everything else is ``linear``.  Returns the one output, or a tuple of
    one a weight."""
    if fused and takes_kernel(x, ws):
        ys = decode_gemm(x, ws)
    else:
        ys = [linear(x, w) for w in ws]
    return ys[0] if len(ws) == 1 else tuple(ys)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's M-RoPE.  x: (B, S, H, D); positions_3d: (3, B, S)
    temporal, height and width ids.  The D/2 frequency slots fall into
    three sections, which take their angle from the temporal, height and
    width id in turn; the rotation is split-halves RoPE in f32."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    freqs = freqs_on(d, theta, x.device)                            # (half,)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        f = freqs[start:start + sec]
        parts.append(positions_3d[i][..., None].float() * f)
        start += sec
    angles = torch.cat(parts, dim=-1)                               # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
