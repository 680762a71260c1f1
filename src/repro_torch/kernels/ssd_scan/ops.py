"""Mamba2 SSD scan: CUDA kernel, plain versions, launch count.

    h_t = exp(-exp(a_log) dt_t) h_{t-1} + dt_t x_t B_t^T;   y_t = h_t C_t

Replaces the TPU kernel ``src/repro/kernels/ssd_scan/ssd_scan.py``
``ssd_scan_pallas`` and its wrapper ``ops.py`` ``ssd_scan`` with the
hand-written Hopper kernel ``kernels/csrc/ssd_scan.cu``, which takes any
``T >= 1`` (the Pallas kernel needs ``T % chunk == 0``), so one kernel
serves the prefill pass (T = prompt) and each decode step (T = 1).  It
has two bodies:

- bf16 x/B/C with ``T >= CHUNKED_MIN_T`` (the served prefill) runs the
  TPU kernel's chunked matmul form on the tensor cores, chunks of
  ``CHUNK`` steps, the f32 operands of its products split into two
  bf16 halves; :func:`ssd_scan_chunked_plain` takes the same steps with
  the same roundings.  Against the recurrence it holds the reference's
  SSD bf16 tolerance (5e-2), as the Pallas kernel does.
- everything else (f32 inputs, and bf16 with short T: the served decode
  step) runs the recurrence, every rounding as :func:`ssd_scan_plain`,
  so the two agree bit for bit.

What bounds it on the H100: at the prefill serving shape (bf16 x/y, B 4,
T 256, H 80, P 64, N 64) the bytes of x, y, dt, B, C and of the f32
state in and out (about 32 MB, 9.6 us at 3.35 TB/s); the chunked
form's products would take 2.7 us at the bf16 tensor-core peak.  The
chunked body is bound by the latency of its chain per chunk (loads,
products, exponentials, barriers) times the chunks; the recurrence by
one step's latency times T.  A decode step moves the state (10.6 MB,
3.2 us).  ``chip_smoke.py`` measures both beside the bound and the
plain version (no single PyTorch call computes the scan).

``ssd_scan`` takes :func:`ssd_scan_plain` only for tensors on the CPU;
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

# kernel launches made by ssd_scan (chip_smoke.py resets and reads it to
# show that the serving path ran the kernel)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_STATE_DIMS = (16, 64)
# bf16 calls with T at or above this take the chunked form (the same
# number as kChunkedMinT in ssd_scan.cu), in chunks of CHUNK steps
CHUNKED_MIN_T = 16
CHUNK = 64
_fn = None


def _tree_sum_n(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (n) as a pairwise tree: n with n + N/2,
    then n + N/4, ...  (N a power of two)."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    return x[..., 0]


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   h_out: Optional[torch.Tensor] = None,
                   y_dtype: Optional[torch.dtype] = None):
    """The reference's ``ssd_scan_ref``, step for step: a loop over T in
    f32.  Arguments and result as :func:`ssd_scan`, whose plain version
    this is (any device and shape; N a power of two).

    Every product and sum is rounded on its own, and the sum over n
    behind y is a pairwise tree: the CUDA kernel takes the same steps in
    the same order, so the two agree bit for bit."""
    bsz, t, h, p = x.shape
    if h0 is None:
        h0 = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float32,
                         device=x.device)
    state = h0.float()
    ea = torch.exp(a_log.float())
    ys = []
    for i in range(t):
        dti = dt[:, i].float()                                    # (B, H)
        a = torch.exp(-(ea * dti))
        dtx = x[:, i].float() * dti[..., None]                    # (B, H, P)
        bt = b[:, i].float()[:, None, None, :]                    # (B,1,1,N)
        ct = c[:, i].float()[:, None, None, :]
        state = state * a[..., None, None] + dtx[..., None] * bt
        ys.append(_tree_sum_n(state * ct))
    y = torch.stack(ys, dim=1).to(y_dtype or x.dtype)
    return y, (state if h_out is None else h_out.copy_(state))


def takes_chunked_form(x: torch.Tensor) -> bool:
    """Whether the kernel runs the chunked form for this x (B, T, H, P)."""
    return x.dtype == torch.bfloat16 and x.shape[1] >= CHUNKED_MIN_T


def bf16_split(v: torch.Tensor):
    """``v`` (f32) as two bf16 halves ``hi = bf16(v)`` and ``lo = bf16(v -
    hi)`` (round to nearest even), both returned in f32: the kernel's
    operands where a product takes an f32 intermediate on the tensor
    cores.  ``|v - hi - lo| <= 2^-17 |v|`` for normal values."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_scan_chunked_plain(x: torch.Tensor, dt: torch.Tensor,
                           a_log: torch.Tensor, b: torch.Tensor,
                           c: torch.Tensor,
                           h0: Optional[torch.Tensor] = None,
                           h_out: Optional[torch.Tensor] = None,
                           y_dtype: Optional[torch.dtype] = None):
    """The kernel's chunked form step for step in PyTorch (any device
    and shape).  Arguments and result as :func:`ssd_scan`.

    Per chunk of ``CHUNK`` steps (the last one ragged), with ``acum``
    the inclusive cumulative sum of ``-exp(a_log) dt`` in f32::

        G' = (C B^T) o exp(acum_i - acum_j) o dt_j   (i >= j; 0 above,
             the exponent set to -inf before exp)
        y  = exp(acum_i) (C h_hi^T + C h_lo^T) + G'_hi x + G'_lo x
        h  = exp(acum_last) h + x^T B'_hi + x^T B'_lo,
             B'_j = B_j exp(acum_last - acum_j) dt_j

    with ``hi``/``lo`` the :func:`bf16_split` halves: x, B and C enter
    the products as they are (exact in bf16), the f32 intermediates G',
    B' and h as two bf16 halves each.  The kernel sums the products in
    another order, so the two agree to f32 rounding, not bit for bit."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    if h0 is None:
        h0 = torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
    state = h0.float()
    ea = torch.exp(a_log.float())
    ys = []
    for t0 in range(0, t, CHUNK):
        t1 = min(t0 + CHUNK, t)
        xs = x[:, t0:t1].float()                                  # (B,Q,H,P)
        d = dt[:, t0:t1].float()                                  # (B,Q,H)
        bs, cs = b[:, t0:t1].float(), c[:, t0:t1].float()         # (B,Q,N)
        acum = torch.cumsum(-(ea * d), dim=1)
        alast = acum[:, -1]                                       # (B,H)
        causal = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        diff = acum[:, :, None, :] - acum[:, None, :, :]          # (B,i,j,H)
        lmat = torch.exp(torch.where(causal, diff, -torch.inf))
        cb = cs @ bs.transpose(1, 2)                              # (B,i,j)
        g_hi, g_lo = bf16_split(cb[..., None] * lmat * d[:, None])
        s_hi, s_lo = bf16_split(state)
        y = (torch.exp(acum)[..., None]
             * (torch.einsum("bin,bhpn->bihp", cs, s_hi)
                + torch.einsum("bin,bhpn->bihp", cs, s_lo))
             + torch.einsum("bijh,bjhp->bihp", g_hi, xs)
             + torch.einsum("bijh,bjhp->bihp", g_lo, xs))
        w = torch.exp(alast[:, None] - acum) * d                  # (B,Q,H)
        bp_hi, bp_lo = bf16_split(bs[:, :, None, :] * w[..., None])
        state = (torch.exp(alast)[..., None, None] * state
                 + torch.einsum("bjhp,bjhn->bhpn", xs, bp_hi)
                 + torch.einsum("bjhp,bjhn->bhpn", xs, bp_lo))
        ys.append(y)
    y = torch.cat(ys, dim=1).to(y_dtype or x.dtype)
    return y, (state if h_out is None else h_out.copy_(state))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").repro_ssd_scan
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, dt, a_log, b, c, h0, h_out, y_dtype) -> None:
    if x.dim() != 4 or dt.shape != x.shape[:3]:
        raise ValueError(f"x (B,T,H,P) and dt (B,T,H) expected, got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    bsz, t, h, p = x.shape
    if b.dim() != 3 or b.shape[:2] != (bsz, t) or c.shape != b.shape:
        raise ValueError(f"b, c of shape ({bsz}, {t}, N) expected, got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    n = b.shape[2]
    if t < 1 or p not in _HEAD_DIMS or n not in _STATE_DIMS:
        raise ValueError(f"T >= 1, head dim in {_HEAD_DIMS} and state dim "
                         f"in {_STATE_DIMS} expected, got T = {t}, P = {p}, "
                         f"N = {n}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"x, b, c: float32 or bfloat16, all one dtype; got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if y_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"y in x's dtype or float32, got {y_dtype}")
    if dt.dtype != torch.float32:
        raise ValueError(f"dt must be float32, got {dt.dtype}")
    if a_log.shape != (h,) or a_log.dtype != torch.float32:
        raise ValueError(f"a_log must be float32 of shape ({h},), got "
                         f"{a_log.dtype} {tuple(a_log.shape)}")
    for name, s in (("h0", h0), ("h_out", h_out)):
        if s.shape != (bsz, h, p, n) or s.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape "
                             f"({bsz}, {h}, {p}, {n}), got {s.dtype} "
                             f"{tuple(s.shape)}")
    for a in (x, dt, a_log, b, c, h0, h_out):
        if a.device != x.device or not a.is_contiguous() \
                or a.data_ptr() % 16:
            raise ValueError("x, dt, a_log, b, c, h0, h_out must be "
                             "contiguous, 16-byte aligned and on one device")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None,
             h_out: Optional[torch.Tensor] = None,
             y_dtype: Optional[torch.dtype] = None):
    """Mamba2 SSD scan.  x: (B, T, H, P) f32 or bf16; dt: (B, T, H)
    f32 after the softplus; a_log: (H,) f32 (A = -exp(a_log)); b, c:
    (B, T, N) in x's dtype, shared by every head; h0: (B, H, P, N) f32
    (zeros when None).

    Returns ``(y (B, T, H, P) in y_dtype (x's when None), h_final (B, H,
    P, N) f32)``.  ``h_final`` is written into ``h_out`` when given,
    which may be ``h0`` itself: the kernel reads each (b, h) state before
    it writes it, so a decode step updates a cache's state in place.  A
    decode step asks for an f32 ``y``, which the reference keeps in f32
    through its D-skip.  bf16 inputs with ``T >= CHUNKED_MIN_T`` run the
    chunked form (:func:`ssd_scan_chunked_plain`'s roundings), all
    others the recurrence (:func:`ssd_scan_plain`'s, bit for bit)."""
    global launches
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, h0, h_out, y_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    bsz, t, h, p = x.shape
    y_dtype = y_dtype or x.dtype
    if h0 is None:
        h0 = torch.zeros(bsz, h, p, b.shape[-1], dtype=torch.float32,
                         device=x.device)
    if h_out is None:
        h_out = torch.empty_like(h0)
    _check(x, dt, a_log, b, c, h0, h_out, y_dtype)
    y = torch.empty(x.shape, dtype=y_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                        b.data_ptr(), c.data_ptr(), h0.data_ptr(),
                        y.data_ptr(), h_out.data_ptr(), bsz, t, h, p,
                        b.shape[2], _DTYPES[x.dtype], _DTYPES[y_dtype],
                        stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, h_out
