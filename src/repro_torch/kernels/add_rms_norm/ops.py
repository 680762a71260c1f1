"""Residual add + RMSNorm: CUDA kernel and plain version.

Replaces no TPU kernel: the reference leaves the residual add and
``rms_norm`` to XLA, which fuses them.  In PyTorch the pair is about ten
small kernels a call, twice a layer of every decode step; the
hand-written Hopper kernel ``kernels/csrc/add_rms_norm.cu`` is one.
``rms_norm`` (the port's only norm, on every path) lives here as the
plain version's second half; ``models.common`` re-exports it.

What bounds it on the H100: the bytes of the rows (a few hundred KB at
the decode shapes), so the launch and one block's chain of loads, sum
and stores.  One block per row, d / 8 threads with 16-byte accesses.
``chip_smoke.py`` measures it beside its bound and the plain version.

``add_rms_norm`` takes the plain version only for tensors on the CPU;
a CUDA tensor launches the kernel (bf16 only) or raises.  The decode
step chooses between the two routes (``models.transformer.fused_decode``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_MAX_D = 8 * 4 * 1024
_launch = build.kernel("add_rms_norm", [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 2 + [ctypes.c_float])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def add_rms_norm_plain(x: torch.Tensor, y, scale: torch.Tensor, eps: float):
    """``(x + y, rms_norm(x + y))`` in x's dtype (``y`` None: ``(x,
    rms_norm(x))``): the residual is rounded to its dtype before the norm
    reads it."""
    if y is not None:
        x = x + y
    return x, rms_norm(x, scale, eps)


def _check(x, y, scale):
    d = x.shape[-1]
    if y is not None and y.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    if scale.shape != (d,):
        raise ValueError(f"scale of shape ({d},) expected, got "
                         f"{tuple(scale.shape)}")
    if d % 8 or not 8 <= d <= _MAX_D:
        raise ValueError(f"last dim {d} must be a multiple of 8 in "
                         f"8..{_MAX_D}")
    for t in (x, y, scale):
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise ValueError(f"bfloat16 expected, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("x, y, scale must be contiguous, 16-byte "
                             "aligned and on one device")


def add_rms_norm(x: torch.Tensor, y, scale: torch.Tensor, eps: float):
    """``(x_new, h)``: ``x_new = x + y`` (``x`` itself when ``y`` is None)
    and ``h = rms_norm(x_new, scale, eps)``, both in x's shape (..., d)."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, y, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, y, scale)
    d = x.shape[-1]
    x_new = x if y is None else torch.empty_like(x)
    h = torch.empty_like(x)
    _launch(x.device, x.data_ptr(), None if y is None else y.data_ptr(),
            scale.data_ptr(), None if y is None else x_new.data_ptr(),
            h.data_ptr(), x.numel() // d, d, eps)
    return x_new, h
