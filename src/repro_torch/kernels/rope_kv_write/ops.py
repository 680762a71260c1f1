"""RoPE of q and k and the KV-cache write of one decode token: CUDA
kernel and plain version.

Replaces no TPU kernel: the reference leaves RoPE and the cache update
of ``attention_decode`` to XLA.  In PyTorch they are about 13 small
kernels for each of q and k, the slot's arithmetic and two
``index_copy_`` calls a layer of every decode step; the hand-written
Hopper kernel ``kernels/csrc/rope_kv_write.cu`` is one.  Split-halves
RoPE (``apply_rope``, with ``rope_freqs``: the port's standard RoPE on
every path) lives here as the plain version's first half;
``models.common`` re-exports it.

What bounds it on the H100: the bytes (q, k, v read, q and two cache
rows written), tens of KB at the decode shapes, so the launch.  One
thread per rotated pair; the position is read on the device.
``chip_smoke.py`` measures it beside its bound and the plain version.

``rope_kv_write`` takes the plain version only for tensors on the CPU;
a CUDA tensor launches the kernel (bf16 only) or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

_launch = build.kernel(
    "rope_kv_write", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6)
_FREQS: dict = {}


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def freqs_on(d: int, theta: float, device: torch.device) -> torch.Tensor:
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
    freqs = freqs_on(d, theta, x.device)                             # (d/2,)
    angles = positions[..., None].float() * freqs                   # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_kv_write_plain(q, k, v, index, ck, cv, theta: float, window: int
                        ) -> torch.Tensor:
    """q: (B, 1, H, D), k and v: (B, 1, KV, D), one token a row at the
    position ``index`` (a 0-dim integer tensor); ck, cv: (B, S, KV, D).
    RoPE on q and k, k and v written into cache slot ``index % S``
    (``window > 0``: a ring buffer) or ``index``, in place.  Returns the
    rotated q as (B, KV, G, D)."""
    b, _, h, d = q.shape
    kvh = k.shape[2]
    index = index.long()
    positions = index.expand(b, 1)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    slot = index % ck.shape[1] if window > 0 else index
    ck.index_copy_(1, slot.view(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.view(1), v.to(cv.dtype))
    return q.reshape(b, kvh, h // kvh, d)


def _check(q, k, v, index, ck, cv):
    if q.dim() != 4 or q.shape[1] != 1 or k.shape != v.shape \
            or ck.dim() != 4 or ck.shape != cv.shape:
        raise ValueError(f"q (B,1,H,D), k, v (B,1,KV,D) and ck, cv "
                         f"(B,S,KV,D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    b, _, h, d = q.shape
    kvh = k.shape[2]
    if k.shape != (b, 1, kvh, d) or ck.shape[0] != b \
            or ck.shape[2:] != (kvh, d) or h % kvh or d % 2:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, cache {tuple(ck.shape)}")
    for t in (q, k, v, ck, cv):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"bfloat16 expected, got {t.dtype}")
    if index.dtype != torch.int32 or index.dim() != 0:
        raise ValueError("index must be a 0-dim int32 tensor")
    for t in (q, k, v, index, ck, cv):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("q, k, v, index, ck, cv must be contiguous and "
                             "on one device")


def rope_kv_write(q, k, v, index, ck, cv, theta: float, window: int
                  ) -> torch.Tensor:
    """``rope_kv_write_plain`` in one launch: RoPE on q and k, k and v
    into their cache slot, read from ``index`` (0-dim int32) on the
    device.  Returns the rotated q as (B, KV, G, D)."""
    if q.device.type == "cpu":
        return rope_kv_write_plain(q, k, v, index, ck, cv, theta, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, index, ck, cv)
    b, _, h, d = q.shape
    kvh, s = k.shape[2], ck.shape[1]
    freqs = freqs_on(d, theta, q.device)
    q_out = torch.empty((b, kvh, h // kvh, d), dtype=q.dtype,
                        device=q.device)
    _launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            index.data_ptr(), freqs.data_ptr(), q_out.data_ptr(),
            ck.data_ptr(), cv.data_ptr(), b, h, kvh, d, s, window)
    return q_out
