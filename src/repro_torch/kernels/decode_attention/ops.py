"""Flash-decode GQA attention: CUDA kernel and plain version.

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

``return_lse=True`` also returns each query row's log-sum-exp of its
scores, (B, KV, G) f32 (the kernel writes it from the softmax state it
combines anyway): the calls of several row ranges of one cache (the
ranks of a sequence-sharded cache) are merged by it into the call over
the whole cache (``merge_by_lse``).

``decode_attention`` takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 80, 128, 224, 256)
_MAX_G = 8
_launch = build.kernel(
    "decode_attention", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_double, ctypes.c_int])


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, return_lse: bool = False,
                           scale: Optional[float] = None):
    """Dense masked decode attention (the reference's ``ref.py``).
    q: (B, KV, G, D); k, v: (B, S, KV, D); lengths: (B,).  Positions at
    or past ``lengths[b]`` get the finite score -1e30.  With
    ``return_lse`` also the (B, KV, G) f32 log-sum-exp of the scores.
    ``scale``: the softmax scale, D^-0.5 when None."""
    b, kvh, g, d = q.shape
    s = k.shape[1]
    qf = q.float() * (d ** -0.5 if scale is None else scale)
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1)
    return out


def merge_by_lse(parts):
    """The outputs of calls over disjoint row ranges of one cache, each
    ``(out, lse)``, merged into the call over all of them: the sum of
    the outputs weighted by ``exp(lse - max lse)`` over the sum of the
    weights, in f32.  A range with no valid row (lse about -1e30) weighs
    exactly 0 beside one that has a valid row."""
    m = torch.stack([lse for _, lse in parts]).amax(0)
    num, den = 0, 0
    for out, lse in parts:
        w = torch.exp(lse - m)
        num = num + out.float() * w[..., None]
        den = den + w
    return num / den[..., None]


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
                     lengths: torch.Tensor, return_lse: bool = False,
                     scale: Optional[float] = None):
    """Flash-decode GQA attention.  q: (B, KV, G, D); k/v: (B, S, KV, D);
    lengths: (B,) int32 valid cache lengths.  Returns (B, KV, G, D), and
    with ``return_lse`` the pair ``(out, lse)``, lse (B, KV, G) f32.
    ``scale``: the softmax scale, D^-0.5 when None (the kernel computes
    that one itself, as it always has)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, return_lse, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, lengths)
    b, kvh, g, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, kvh, g), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, k.shape[1], kvh, g,
            d, 0.0 if scale is None else float(scale), _DTYPES[q.dtype])
    return (out, lse) if return_lse else out
