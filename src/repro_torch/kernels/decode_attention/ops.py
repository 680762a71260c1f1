"""Flash-decode GQA attention: CUDA kernel, plain version, launch count.

Replaces the TPU kernel
``src/repro/kernels/decode_attention/decode_attention.py``
``decode_attention_pallas`` and its wrapper ``ops.py`` ``decode_attention``
with the hand-written Hopper kernel ``kernels/csrc/decode_attention.cu``.

What bounds it on the H100: the bytes of K and V read from the cache
(the G query heads of a KV head share one pass over its rows, so the
arithmetic intensity is about G); at the serving shapes those are a few
MB at most, so load latency and launch latency bound it.  The kernel is
split by the storage type.  In bf16, the served type, the rows of each
(batch row, KV head) are split over a thread-block cluster of up to 8
blocks in one launch, each block reads only the valid rows of its range
(``lengths[b] > 0``) with 16-byte loads that put several rows in flight,
and the blocks combine their softmax states through distributed shared
memory, each block a share of the outputs.  In f32 (full-width parity, the tests) it is the first
port's kernel, unchanged: one block per (batch row, KV head).
``chip_smoke.py`` measures it beside its bound, the plain version and a
masked ``scaled_dot_product_attention``.

``decode_attention`` takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches made by decode_attention (chip_smoke.py resets and
# reads it to show that the serving path ran the kernel)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_MAX_G = 8
_fn = None


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Dense masked decode attention (the reference's ``ref.py``).
    q: (B, KV, G, D); k, v: (B, S, KV, D); lengths: (B,).  Positions at
    or past ``lengths[b]`` get the finite score -1e30."""
    b, kvh, g, d = q.shape
    s = k.shape[1]
    qf = q.float() * (d ** -0.5)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").repro_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, lengths):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,KV,G,D) and k, v (B,S,KV,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, kvh, g, d = q.shape
    if k.shape[0] != b or k.shape[2] != kvh or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"float32 or bfloat16 expected, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS or not 1 <= g <= _MAX_G:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS} or group {g} "
                         f"not in 1..{_MAX_G}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 of shape ({b},)")
    for t in (q, k, v, lengths):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("q, k, v, lengths must be contiguous, 16-byte "
                             "aligned and on one device")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Flash-decode GQA attention.  q: (B, KV, G, D); k/v: (B, S, KV, D);
    lengths: (B,) int32 valid cache lengths.  Returns (B, KV, G, D)."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, lengths)
    b, kvh, g, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        lengths.data_ptr(), out.data_ptr(), b, k.shape[1],
                        kvh, g, d, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    return out
