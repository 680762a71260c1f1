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


def to_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def dense_init(gen: torch.Generator, shape, dtype, fan_in: int | None = None
               ) -> torch.Tensor:
    """Truncated-normal init in [-2, 2] scaled by 1/sqrt(fan_in), drawn
    on the generator's device."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


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


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


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


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


_FREQS: dict = {}


def _freqs_on(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as a tensor on ``device``, copied there once: a
    copy from host memory on every call would wait for the device."""
    key = (d, theta, device)
    if key not in _FREQS:
        _FREQS[key] = torch.from_numpy(rope_freqs(d, theta)).to(device)
    return _FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Split-halves RoPE (not
    interleaved pairs), computed in f32."""
    d = x.shape[-1]
    freqs = _freqs_on(d, theta, x.device)                            # (d/2,)
    angles = positions[..., None].float() * freqs                   # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's M-RoPE.  x: (B, S, H, D); positions_3d: (3, B, S)
    temporal, height and width ids.  The D/2 frequency slots fall into
    three sections, which take their angle from the temporal, height and
    width id in turn; the rotation is split-halves RoPE in f32."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    freqs = _freqs_on(d, theta, x.device)                            # (half,)
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
