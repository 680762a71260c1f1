"""The Mamba2 decode step's D-skip and gated group norm: CUDA kernel and
plain version.

Replaces no TPU kernel: the reference leaves the D-skip after a decode
step's SSD scan, the cast back, the gate ``y * silu(z)`` and the RMSNorm
of each group of ``d_inner / G`` channels to XLA, which fuses them.  In
PyTorch the chain is about fifteen small kernels a layer of every decode
step; the hand-written Hopper kernel ``kernels/csrc/mamba2_gate_norm.cu``
is one.  ``gated_norm`` (the prefill's and the forward's gate and norm
too) lives here as the plain version's second half; ``models.mamba2``
imports it.

What bounds it on the H100: the bytes (the scan's f32 y, xc, z and the
norm's scale read, the output written: 12 d_inner bytes a row, 86 KB at
Zamba2-7B's widths), so the launch and one block's chain of loads, sum
and stores.  One block per (row, group), 16-byte accesses.
``chip_smoke.py`` measures it beside its bound and the plain version.

``mamba2_gate_norm`` takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernel (f32 y, bf16 activations and
scale, ``d_skip`` f32 or bf16) or raises.  The decode step chooses
between the two routes (``models.transformer.fused_decode``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.add_rms_norm.ops import rms_norm

_MAX_GROUP = 8 * 4 * 1024
_LEAF_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = build.kernel(
    "mamba2_gate_norm", [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_float])


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)``, per group of ``d_inner / G`` channels."""
    if groups == 1:
        return rms_norm(y * F.silu(z), scale, eps)
    v = (y * F.silu(z)).unflatten(-1, (groups, -1))
    return rms_norm(v, scale.view(groups, -1), eps).flatten(-2)


def mamba2_gate_norm_plain(y: torch.Tensor, xh: torch.Tensor,
                           d_skip: torch.Tensor, z: torch.Tensor,
                           scale: torch.Tensor, groups: int, eps: float
                           ) -> torch.Tensor:
    """The decode step's chain after the scan: the D-skip on the scan's
    f32 ``y`` (B, 1, H, P) with the conv output ``xh`` (B, 1, H, P) in
    f32, the cast to z's dtype, then ``gated_norm``.  Returns (B, 1, H P)
    in z's dtype."""
    b, _, h, p = xh.shape
    y = y[:, 0] + xh[:, 0].float() * d_skip.float()[None, :, None]
    y = y.reshape(b, 1, h * p).to(z.dtype)
    return gated_norm(y, z, scale, groups, eps)


def _check(y, xh, d_skip, z, scale, groups):
    if y.dim() != 4 or y.shape[1] != 1 or xh.shape != y.shape:
        raise ValueError(f"y and xh of one shape (B, 1, H, P) expected, got "
                         f"{tuple(y.shape)}, {tuple(xh.shape)}")
    b, _, h, p = y.shape
    di = h * p
    if z.shape != (b, 1, di) or scale.shape != (di,) \
            or d_skip.shape != (h,):
        raise ValueError(f"z ({b}, 1, {di}), scale ({di},) and d_skip "
                         f"({h},) expected, got {tuple(z.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(d_skip.shape)}")
    group = di // groups if groups > 0 and di % groups == 0 else 0
    if p % 8 or group % 8 or not 8 <= group <= _MAX_GROUP:
        raise ValueError(f"head dim {p} and group width {di} / {groups} "
                         f"multiples of 8, the group at most {_MAX_GROUP}, "
                         f"expected")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be float32, got {y.dtype}")
    for t in (xh, z, scale):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"bfloat16 expected, got {t.dtype}")
    if d_skip.dtype not in _LEAF_DTYPES:
        raise ValueError(f"d_skip: float32 or bfloat16, got {d_skip.dtype}")
    for t in (y, xh, d_skip, z, scale):
        dense = (t.stride(-1) == 1 and t.stride(0) % 8 == 0) if t is z \
            else t.is_contiguous()
        if t.device != y.device or not dense:
            raise ValueError("the operands must be on one device and "
                             "contiguous (z: rows of unit stride)")
    if any(t.data_ptr() % 16 for t in (y, xh, z, scale)):
        raise ValueError("y, xh, z and scale must be 16-byte aligned")


def mamba2_gate_norm(y: torch.Tensor, xh: torch.Tensor, d_skip: torch.Tensor,
                     z: torch.Tensor, scale: torch.Tensor, groups: int,
                     eps: float) -> torch.Tensor:
    """``mamba2_gate_norm_plain`` in one launch: (B, 1, H P) in z's
    dtype."""
    if y.device.type == "cpu":
        return mamba2_gate_norm_plain(y, xh, d_skip, z, scale, groups, eps)
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    _check(y, xh, d_skip, z, scale, groups)
    b, _, h, p = y.shape
    out = torch.empty((b, 1, h * p), dtype=z.dtype, device=y.device)
    _launch(y.device, y.data_ptr(), xh.data_ptr(), d_skip.data_ptr(),
            _LEAF_DTYPES[d_skip.dtype], z.data_ptr(), z.stride(0),
            scale.data_ptr(), out.data_ptr(), b, h * p, groups, p, eps)
    return out
