"""WKV6 recurrence (RWKV-6 time mix): CUDA kernel and plain version.

    y_t = r_t^T (S_{t-1} + u k_t v_t^T);   S_t = diag(w_t) S_{t-1} + k_t v_t^T

Replaces the TPU kernel ``src/repro/kernels/rwkv6_scan/rwkv6_scan.py``
``rwkv6_scan_pallas`` and its wrapper ``ops.py`` ``rwkv6_scan`` with the
hand-written Hopper kernel ``kernels/csrc/rwkv6_scan.cu``.  Unlike the
Pallas kernel (``T % block_t == 0``) it takes any ``T >= 1``, so one
kernel serves the prefill pass (T = prompt) and each decode step (T = 1).

The kernel keeps the plain version's exact contract: every product and
sum rounded on its own, in :func:`rwkv6_scan_plain`'s order, with the
sum over i as the same pairwise tree, so the two agree bit for bit in
f32 and bf16 (full-width f32 parity of rwkv6 is exact).  Four threads
share each state column, each holding rows ``i = q + 4 m`` and serving
two columns; the tree's last two levels run across lanes.

What bounds it on the H100: at the prefill serving shape the bytes of
r/k/v/w/y and of the state in and out (about 29 MB, 8.8 us at 3.35
TB/s) and the f32 arithmetic at the f32 peak (8 us) lie below what the
exact contract costs: six rounded operations per state entry and step
that cannot fuse, the shared-memory reads of r, k, w and each step's
chain through the sum, times T, with one block per (batch, head).
``chip_smoke.py`` measures it beside its bound and the plain version
(no single PyTorch call computes WKV6).

``rwkv6_scan`` takes the plain version only for tensors on the CPU; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_launch = build.kernel(
    "rwkv6_scan", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5)


def _tree_sum_i(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 (i) of (..., D, D) as a pairwise tree: i with
    i + D/2, then i + D/4, ...  (D a power of two)."""
    n = x.shape[-2]
    while n > 1:
        n //= 2
        x = x[..., :n, :] + x[..., n:2 * n, :]
    return x[..., 0, :]


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None,
                     s_out: Optional[torch.Tensor] = None):
    """The reference's ``rwkv6_scan_ref``, term for term: a loop over T
    in f32.  Arguments and result as :func:`rwkv6_scan`, whose plain
    version this is (any device, shape and dtype).

    The sum over i behind y is a pairwise tree, each elementwise step
    rounded on its own: the CUDA kernel takes the same steps in the same
    order, so the two agree bit for bit."""
    if s0 is None:
        b, _, h, d = r.shape
        s0 = torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
    state = s0.float()
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))   # (B,H,D)
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(_tree_sum_i(rt[..., :, None] * (state + uu * kv)))
        state = state * wt[..., None] + kv
    y = torch.stack(ys, dim=1).to(r.dtype)
    return y, (state if s_out is None else s_out.copy_(state))


def _check(r, k, v, w, u, s0, s_out) -> None:
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or w.shape != r.shape:
        raise ValueError(f"r, k, v, w of one shape (B,T,H,D) expected, got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    b, t, h, d = r.shape
    if t < 1 or d not in _HEAD_DIMS:
        raise ValueError(f"T >= 1 and head dim in {_HEAD_DIMS} expected, "
                         f"got T = {t}, D = {d}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v: float32 or bfloat16, all one dtype; got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"w must be float32, got {w.dtype}")
    if u.shape != (h, d) or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 of shape ({h}, {d}), got "
                         f"{u.dtype} {tuple(u.shape)}")
    for name, s in (("s0", s0), ("s_out", s_out)):
        if s.shape != (b, h, d, d) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape "
                             f"({b}, {h}, {d}, {d}), got {s.dtype} "
                             f"{tuple(s.shape)}")
    for x in (r, k, v, w, u, s0, s_out):
        if x.device != r.device or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError("r, k, v, w, u, s0, s_out must be contiguous, "
                             "16-byte aligned and on one device")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None,
               s_out: Optional[torch.Tensor] = None):
    """WKV6 recurrence.  r, k, v: (B, T, H, D) f32 or bf16; w: (B, T, H, D)
    decay in (0, 1), f32 (a bf16 ``w`` is widened to f32, exactly); u:
    (H, D) f32; s0: (B, H, D, D) f32 (zeros when None).

    Returns ``(y (B, T, H, D) in r's dtype, s_final (B, H, D, D) f32)``.
    ``s_final`` is written into ``s_out`` when given, which may be ``s0``
    itself: the kernel reads each (b, h) state before it writes it, so a
    decode step updates a cache's state in place."""
    b, t, h, d = r.shape
    if w.dtype == torch.bfloat16:
        w = w.float()
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, s0, s_out)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    if s0 is None:
        s0 = torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
    if s_out is None:
        s_out = torch.empty_like(s0)
    _check(r, k, v, w, u, s0, s_out)
    y = torch.empty_like(r)
    _launch(r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), u.data_ptr(), s0.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), b, t, h, d, _DTYPES[r.dtype])
    return y, s_out
