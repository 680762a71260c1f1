"""Mamba2 (SSD) mixer: the chunked training form, prefill over the
prompt and the recurrent decode step.

Counterpart of ``repro.models.mamba2``.  Per SSD head, with a (P, N)
state h and A = -exp(a_log):

    h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T;   y_t = h_t C_t + D x_t

The no-cache forward (``mamba2_fwd(..., train_form=True)``, the training
path) runs the reference's chunked matmul form ``ssd_chunked``.  The
reference's prefill runs that form too and its decode step the one-step
recurrence; here ``ssd`` routes both through the Hopper ``ssd_scan``
kernel when asked (the block functions ask with
``cfg.use_pallas_prefill`` for the prefill pass, T = prompt, and
``cfg.use_pallas_decode`` for a decode step, T = 1) and through the
kernel's plain version otherwise.  As in the reference, the prefill and
the forward add the D-skip in x's dtype after y comes back in x's
dtype, while a decode step keeps y in f32 through the D-skip and casts
once after it.

When given ``out`` (a layer's views into the decode cache), the mixer
writes its new conv windows and SSD state there in place; the SSD state
is updated by the kernel itself (its output aliases its input state).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.models import sharding as sh
from repro_torch.models.common import dense_init, keep_in, linear, rms_norm


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    h, w = cfg.ssm_num_heads, cfg.ssm_conv_width
    dev, f32 = gen.device, torch.float32
    return {
        "w_zx": dense_init(gen, (d, 2 * di), dtype),
        "w_bc": dense_init(gen, (d, 2 * n), dtype),
        "w_dt": dense_init(gen, (d, h), dtype),
        "dt_bias": torch.zeros(h, dtype=f32, device=dev),
        "a_log": torch.zeros(h, dtype=f32, device=dev),      # A = -exp(a_log)
        "d_skip": torch.ones(h, dtype=f32, device=dev),
        "conv_x": dense_init(gen, (w, di), dtype, fan_in=w),
        "conv_bc": dense_init(gen, (w, 2 * n), dtype, fan_in=w),
        "norm": torch.zeros(di, dtype=dtype, device=dev),
        "w_out": dense_init(gen, (di, d), dtype, fan_in=di),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time, then SiLU.  x: (B, S, C); w:
    (W, C); state: the (B, W-1, C) inputs before x, zeros when None.
    Returns ``(y, new_state)``, new_state the trailing W-1 inputs.  The
    taps are summed as the reference's ``sum``: from 0, tap 0 first,
    each product and sum in x's dtype."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], width - 1, x.shape[2])
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    return F.silu(y), xp[:, -(width - 1):]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int = 128,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan, the reference's form.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); b, c: (B, S, N);
    a_log: (H,).  Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N)
    f32).  A ragged S is padded to whole chunks with zeros.

    The reference's three-operand einsums are contracted pairwise in
    its operand order (the first two operands' elementwise product, then
    the contraction with the third), which never makes a (q, q, P)
    tensor.  The intra-chunk gate masks the decay before the exp, where
    the reference exponentiates every (i, j) and masks after: the values
    are the same, but above the diagonal the decay is positive and its
    exp overflows once a chunk's decay sums past ~88, which makes the
    reference's gradient NaN there (0 * inf).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    q = chunk

    xc = x.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b.reshape(bsz, nc, q, n).float()
    cc = c.reshape(bsz, nc, q, n).float()

    loga = -torch.exp(a_log)[None, None, None, :] * dtc    # (B,nc,q,H) <= 0
    acum = torch.cumsum(loga, dim=2)                        # inclusive
    dtx = xc * dtc[..., None]                               # (B,nc,q,H,P)

    # intra-chunk: S_ij = (C_i . B_j) * exp(acum_i - acum_j) for i >= j
    # (h_t = a_t h_{t-1} + dt_t B_t x_t: own-step input is NOT decayed)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)            # (B,nc,q,q)
    decay = acum[:, :, :, None, :] - acum[:, :, None, :, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    gate = torch.exp(decay.masked_fill(~mask[None, None, :, :, None],
                                       float("-inf")))
    # einsum("bcij,bcijh,bcjhp->bcihp", cb, gate, dtx)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * gate, dtx)

    # per-chunk outgoing state (before adding incoming):
    # h_chunk = sum_j exp(acum_Q - acum_j) * dtx_j  (x)  B_j
    tail = acum[:, :, -1:, :]                               # (B,nc,1,H)
    sdecay = torch.exp(tail - acum)                         # (B,nc,q,H)
    # einsum("bcjn,bcjh,bcjhp->bchpn", bc, sdecay, dtx)
    h_chunk = torch.einsum("bcjnh,bcjhp->bchpn",
                           bc[..., :, None] * sdecay[..., None, :], dtx)
    chunk_gain = torch.exp(tail[:, :, 0, :])                # (B,nc,H)

    # inter-chunk recurrence over chunk index
    hprev = (torch.zeros(bsz, h, p, n, dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    h_in = []
    for i in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_gain[:, i, :, None, None] + h_chunk[:, i]
    h_in = torch.stack(h_in, dim=1)                         # (B,nc,H,P,N)

    # inter contribution: y_i += exp(acum_i) * C_i . h_in
    # einsum("bcin,bcih,bchpn->bcihp", cc, exp(acum), h_in)
    y_inter = torch.einsum("bcinh,bchpn->bcihp",
                           cc[..., :, None] * torch.exp(acum)[..., None, :],
                           h_in)
    y = (y_diag + y_inter).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype), hprev


def ssd(x, dt, a_log, b, c, h0=None, *, kernel: bool = False, out=None,
        y_dtype=None, mesh=None):
    """SSD recurrence.  x: (B,S,H,P); dt: (B,S,H) f32; b, c: (B,S,N).
    Returns (y (B,S,H,P) in ``y_dtype`` or x's, h_final (B,H,P,N) f32).
    ``kernel`` runs the ``ssd_scan`` kernel, else its plain version;
    ``out`` receives h_final (it may be ``h0``).  Under ``mesh`` the scan
    runs per rank through ``local_map`` (it is independent per (batch,
    head)): the batch over the data axes, the heads over ``model`` where
    they divide it."""
    scan = ssd_scan if kernel else ssd_scan_plain
    if mesh is None:
        return scan(x, dt, a_log, b.contiguous(), c.contiguous(), h0,
                    h_out=out, y_dtype=y_dtype)
    dp = sh.dp_axes(mesh)
    heads = "model" if x.shape[2] % sh.axis_size(mesh, "model") == 0 \
        else None
    xs, st = (dp, None, heads, None), (dp, heads, None, None)
    bs = (dp, None, None)
    y, h_final = sh.local_call(
        lambda x, dt, a_log, b, c, h0: scan(
            x, dt, a_log, b.contiguous(), c.contiguous(), h0,
            y_dtype=y_dtype),
        mesh, (xs, (dp, None, heads), (heads,), bs, bs,
               None if h0 is None else st),
        [xs, st], x, dt, a_log, b, c, h0)
    if out is not None:
        out.copy_(h_final)
        h_final = out
    return y, h_final


def _in_proj(params, x: torch.Tensor, cfg: ModelConfig):
    """z, x and the B|C input of the convs, and dt (f32, softplus)."""
    di = cfg.d_inner
    zx = linear(x, params["w_zx"])
    dt = F.softplus(linear(x, params["w_dt"]).float() + params["dt_bias"])
    return zx[..., :di], zx[..., di:], linear(x, params["w_bc"]), dt


def mamba2_fwd(params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[dict] = None, *, kernel: bool = False,
               train_form: bool = False, out: Optional[dict] = None,
               mesh=None):
    """Full-sequence forward.  x: (B, S, d_model).  state: {"conv_x",
    "conv_bc", "h"} or None (zeros).  Returns ``(y, new_state)``; with
    ``out`` the new state is written into its tensors (which may be
    ``state``'s).  ``train_form`` (the no-cache forward) runs the SSD as
    the reference's forward does, ``ssd_chunked``; otherwise through
    ``ssd`` (``kernel`` as there)."""
    b, s, _ = x.shape
    n, h, p = cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xin, bcin, dt = _in_proj(params, x, cfg)
    xc, conv_x = _causal_conv(xin, params["conv_x"],
                              state["conv_x"] if state else None)
    bcc, conv_bc = _causal_conv(bcin, params["conv_bc"],
                                state["conv_bc"] if state else None)
    xh = sh.split_last(xc, h, p)
    h0 = state["h"] if state else None
    if train_form:
        y, h_final = ssd_chunked(xh, dt, params["a_log"], bcc[..., :n],
                                 bcc[..., n:], h0=h0)
    else:
        y, h_final = ssd(xh, dt, params["a_log"], bcc[..., :n],
                         bcc[..., n:], h0, kernel=kernel,
                         out=None if out is None else out["h"], mesh=mesh)
    skip = params["d_skip"][None, None, :, None].to(y.dtype)
    y = y + xh.float().to(y.dtype) * skip
    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return linear(y, params["w_out"]), {
        "conv_x": keep_in(out, "conv_x", conv_x),
        "conv_bc": keep_in(out, "conv_bc", conv_bc), "h": h_final}


def mamba2_decode(params, x: torch.Tensor, cfg: ModelConfig, state: dict, *,
                  kernel: bool = False, out: Optional[dict] = None,
                  mesh=None):
    """Single-token recurrent step.  x: (B, 1, d_model); state and
    ``out`` as in :func:`mamba2_fwd`."""
    b = x.shape[0]
    n, h, p = cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xin, bcin, dt = _in_proj(params, x, cfg)
    xc, conv_x = _causal_conv(xin, params["conv_x"], state["conv_x"])
    bcc, conv_bc = _causal_conv(bcin, params["conv_bc"], state["conv_bc"])
    y, h_new = ssd(sh.split_last(xc, h, p), dt, params["a_log"], bcc[..., :n],
                   bcc[..., n:], state["h"], kernel=kernel,
                   out=None if out is None else out["h"],
                   y_dtype=torch.float32, mesh=mesh)
    xh = sh.split_last(xc[:, 0], h, p).float()
    y = y[:, 0] + xh * params["d_skip"][None, :, None]
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return linear(y, params["w_out"]), {
        "conv_x": keep_in(out, "conv_x", conv_x),
        "conv_bc": keep_in(out, "conv_bc", conv_bc), "h": h_new}


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device,
                      layers: int):
    """Zero decode state of ``layers`` layers, each axis led by the layer:
    the reference's per-layer ``init_mamba2_state`` stacked."""
    di, n = cfg.d_inner, cfg.ssm_state_dim
    h, p, w = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_conv_width
    return {
        "conv_x": torch.zeros(layers, batch, w - 1, di, dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros(layers, batch, w - 1, 2 * n, dtype=dtype,
                               device=device),
        "h": torch.zeros(layers, batch, h, p, n, dtype=torch.float32,
                         device=device),
    }
