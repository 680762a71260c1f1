"""Causal sliding-window prefill attention: CUDA kernel, plain version, count.

Replaces the TPU kernel ``src/repro/kernels/swa_prefill/swa_prefill.py``
``swa_prefill_pallas`` and its wrapper ``ops.py`` ``swa_prefill_attention``
with the hand-written Hopper kernel ``kernels/csrc/swa_prefill.cu``.

The kernel is split by the storage type.  In bf16, the served type, it
is a FlashAttention-2-style forward on the tensor cores (``mma.sync``
m16n8k16, f32 accumulators): 64 query rows per block in 4 warps, K/V
tiles of 64 keys kept in bf16 in a two-stage shared-memory ring filled
with ``cp.async``, the scores scaled in f32, the online softmax in
registers and P fed from registers into P V.  In f32 (full-width
parity, the tests) it is the first port's CUDA-core kernel, unchanged,
because tensor cores would take f32 through TF32 (about 1e-3
relative), above the repo's f32 tolerance of 2e-5.  Both index the KV
head of each query head directly instead of repeating K/V over the GQA
groups, and skip every K/V tile outside the window band.

What bounds it on the H100: at the serving shapes (S = 256, D = 64 or
80) the bytes and the operations of one call are small, so latency
bounds it: each warp's chain of key tiles (products, softmax,
products) and the load of the first tile.  At a 4096-token prompt the
tensor cores' ``mma.sync`` rate does.  ``chip_smoke.py`` measures it
beside its bound, the plain version and PyTorch's
``scaled_dot_product_attention``.

``swa_prefill_attention`` takes the plain version only for tensors on
the CPU; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches made by swa_prefill_attention (chip_smoke.py resets and
# reads it to show that the serving path ran the kernel)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_fn = None


def swa_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int) -> torch.Tensor:
    """Dense masked causal sliding-window attention (the reference's
    ``ref.py`` with the GQA repeat of its wrapper).  q: (B, S, H, D);
    k, v: (B, S, KV, D).  Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    pos = torch.arange(s, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = (rel >= 0) & (rel < window)
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("swa_prefill").repro_swa_prefill
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B,S,H,D) and k, v (B,S,KV,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"float32 or bfloat16 expected, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("q, k, v must be contiguous, 16-byte aligned "
                             "and on one device")


def swa_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int) -> torch.Tensor:
    """Causal SWA prefill.  q: (B, S, H, D); k, v: (B, S, KV, D) with
    H % KV == 0.  Returns (B, S, H, D).  Full causal attention is
    ``window >= S``."""
    global launches
    if q.device.type == "cpu":
        return swa_prefill_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, h, k.shape[2], d, int(window),
                        _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"swa_prefill kernel launch failed: CUDA error {err}")
    launches += 1
    return out
