"""The Mamba2 decode step's conv window: CUDA kernel and plain
version.

Replaces no TPU kernel: the reference leaves a decode step's two
depthwise causal convs (with their biases where the layer has them, and
SiLU), the shift of their windows, dt's softplus and the widening of
``a_log`` to XLA, which fuses them.  In PyTorch the chain is about thirty
small kernels a layer of every decode step; the hand-written Hopper
kernel ``kernels/csrc/mamba2_conv_step.cu`` is one, which also writes B
and C contiguous in the layout ``ssd_scan`` takes.  ``causal_conv`` and
``split_bc`` (the prefill's and the forward's conv and split too) live
here as the plain version's parts; ``models.mamba2`` imports them.

What bounds it on the H100: the bytes (each window read and written, the
conv weights and the inputs read, the outputs written: about 0.2 MB a
row at Zamba2-7B's widths), so the launch.  One thread per 8 channels
with 16-byte accesses.  ``chip_smoke.py`` measures it beside its bound
and the plain version.

``mamba2_conv_step`` takes the plain version only for tensors on the
CPU; a CUDA tensor launches the kernel (bf16 activations and conv
weights; ``dt_bias`` and ``a_log`` f32 or bf16) or raises.  The decode
step chooses between the two routes (``models.transformer.fused_decode``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_WIDTH = 4                 # Mamba2's conv width, every configuration's
_LEAF_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_launch = build.kernel(
    "mamba2_conv_step", [ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time, then SiLU.  x: (B, S, C); w:
    (W, C); state: the (B, W-1, C) inputs before x, zeros when None;
    ``bias`` (C,) added after the taps (published Zamba2's).  Returns
    ``(y, new_state)``, new_state the trailing W-1 inputs.  The taps are
    summed as the reference's ``sum``: from 0, tap 0 first, each product
    and sum in x's dtype."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], width - 1, x.shape[2])
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    if bias is not None:
        y = y + bias
    return F.silu(y), xp[:, -(width - 1):]


def split_bc(bcc: torch.Tensor, groups: int):
    """B and C of the conv's B|C output (..., 2 G N): (..., N) each for
    one group, else (..., G, N)."""
    gn = bcc.shape[-1] // 2
    if groups == 1:
        return bcc[..., :gn], bcc[..., gn:]
    return (bcc[..., :gn].unflatten(-1, (groups, -1)),
            bcc[..., gn:].unflatten(-1, (groups, -1)))


def mamba2_conv_step_plain(params: dict, xin: torch.Tensor,
                           bcin: torch.Tensor, dt_raw: torch.Tensor,
                           state: dict, groups: int,
                           out: Optional[dict] = None):
    """The decode step's chain before the scan: both convs over their
    windows (``state["conv_x"]``, ``state["conv_bc"]``) and the new
    inputs, B and C split, dt's softplus and ``a_log`` in f32.  Returns
    ``(xc, b, c, dt, a_log, conv_x, conv_bc)``, the last two the shifted
    windows, written into ``out``'s tensors when given (which may be
    ``state``'s)."""
    xc, conv_x = causal_conv(xin, params["conv_x"], state["conv_x"],
                             params.get("conv_x_bias"))
    bcc, conv_bc = causal_conv(bcin, params["conv_bc"], state["conv_bc"],
                               params.get("conv_bc_bias"))
    bm, cm = split_bc(bcc, groups)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    if out is not None:
        conv_x = out["conv_x"].copy_(conv_x)
        conv_bc = out["conv_bc"].copy_(conv_bc)
    return xc, bm, cm, dt, params["a_log"].float(), conv_x, conv_bc


def _check(xin, bcin, dt_raw, w_x, w_bc, b_x, b_bc, dt_bias, a_log, wins,
           groups):
    if xin.dim() != 3 or xin.shape[1] != 1 or bcin.shape[:2] != xin.shape[:2] \
            or dt_raw.shape[:2] != xin.shape[:2]:
        raise ValueError(f"xin (B, 1, d_inner), bcin (B, 1, 2 G N) and "
                         f"dt_raw (B, 1, H) expected, got {tuple(xin.shape)}, "
                         f"{tuple(bcin.shape)}, {tuple(dt_raw.shape)}")
    bsz, _, di = xin.shape
    cbc, heads, width = bcin.shape[-1], dt_raw.shape[-1], w_x.shape[0]
    if width != _WIDTH:
        raise ValueError(f"conv width {_WIDTH} expected, got {width}")
    if di % 8 or cbc % (16 * groups):
        raise ValueError(f"d_inner {di} a multiple of 8 and 2 G N {cbc} of "
                         f"16 G (G = {groups}) expected")
    want = {"w_x": (w_x, (width, di)), "w_bc": (w_bc, (width, cbc)),
            "b_x": (b_x, (di,)), "b_bc": (b_bc, (cbc,)),
            "conv_x window": (wins[0], (bsz, width - 1, di)),
            "conv_bc window": (wins[1], (bsz, width - 1, cbc)),
            "conv_x window out": (wins[2], (bsz, width - 1, di)),
            "conv_bc window out": (wins[3], (bsz, width - 1, cbc)),
            "dt_bias": (dt_bias, (heads,)), "a_log": (a_log, (heads,))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} of shape {shape} expected, got "
                             f"{tuple(t.shape)}")
    for t in (xin, bcin, dt_raw, w_x, w_bc, b_x, b_bc, *wins):
        if t is not None and t.dtype != torch.bfloat16:
            raise ValueError(f"bfloat16 expected, got {t.dtype}")
    for t in (dt_bias, a_log):
        if t.dtype not in _LEAF_DTYPES:
            raise ValueError(f"dt_bias and a_log: float32 or bfloat16, got "
                             f"{t.dtype}")
    vector = (xin, bcin, w_x, w_bc, b_x, b_bc, *wins)
    for t in (*vector, dt_raw, dt_bias, a_log):
        if t is None:
            continue
        dense = (t.stride(-1) == 1 and t.stride(0) % 8 == 0) if t is xin \
            else t.is_contiguous()
        if t.device != xin.device or not dense:
            raise ValueError("the operands must be on one device and "
                             "contiguous (xin: rows of unit stride)")
    if any(t is not None and t.data_ptr() % 16 for t in vector):
        raise ValueError("xin, bcin, the windows, the conv weights and "
                         "biases must be 16-byte aligned")


def mamba2_conv_step(params: dict, xin: torch.Tensor, bcin: torch.Tensor,
                     dt_raw: torch.Tensor, state: dict, groups: int,
                     out: Optional[dict] = None):
    """``mamba2_conv_step_plain`` in one launch: the windows are read
    from ``state`` and the shifted ones written into ``out`` (new
    tensors when None); each thread reads its channels' whole window
    before it writes, so ``out`` may be ``state``.  B and C come back
    contiguous."""
    if xin.device.type == "cpu":
        return mamba2_conv_step_plain(params, xin, bcin, dt_raw, state,
                                      groups, out)
    if xin.device.type != "cuda":
        raise ValueError(f"no kernel for device {xin.device}")
    w_x, w_bc = params["conv_x"], params["conv_bc"]
    b_x, b_bc = params.get("conv_x_bias"), params.get("conv_bc_bias")
    dt_bias, a_log = params["dt_bias"], params["a_log"]
    win_x, win_bc = state["conv_x"], state["conv_bc"]
    new_x = torch.empty_like(win_x) if out is None else out["conv_x"]
    new_bc = torch.empty_like(win_bc) if out is None else out["conv_bc"]
    _check(xin, bcin, dt_raw, w_x, w_bc, b_x, b_bc, dt_bias, a_log,
           (win_x, win_bc, new_x, new_bc), groups)
    bsz, _, di = xin.shape
    gn, heads = bcin.shape[-1] // 2, dt_raw.shape[-1]
    xc = torch.empty((bsz, 1, di), dtype=xin.dtype, device=xin.device)
    shape = (bsz, 1, gn) if groups == 1 else (bsz, 1, groups, gn // groups)
    bm = torch.empty(shape, dtype=xin.dtype, device=xin.device)
    cm = torch.empty_like(bm)
    dt = torch.empty(dt_raw.shape, dtype=torch.float32, device=xin.device)
    a_out = torch.empty(heads, dtype=torch.float32, device=xin.device)
    _launch(
        xin.device, xin.data_ptr(), xin.stride(0), bcin.data_ptr(),
        win_x.data_ptr(), win_bc.data_ptr(), new_x.data_ptr(), new_bc.data_ptr(),
        w_x.data_ptr(), w_bc.data_ptr(),
        None if b_x is None else b_x.data_ptr(),
        None if b_bc is None else b_bc.data_ptr(), dt_raw.data_ptr(),
        dt_bias.data_ptr(), _LEAF_DTYPES[dt_bias.dtype], a_log.data_ptr(),
        _LEAF_DTYPES[a_log.dtype], xc.data_ptr(), bm.data_ptr(),
        cm.data_ptr(), dt.data_ptr(), a_out.data_ptr(), bsz, di, gn,
        heads, w_x.shape[0])
    return xc, bm, cm, dt, a_out, new_x, new_bc
