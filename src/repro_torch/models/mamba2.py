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

A decode step on ``transformer.fused_decode``'s route (bf16 on the card,
the kernel route, no mesh) runs the chains around the scan as two
hand-written kernels: ``mamba2_conv_step`` (both depthwise convs over
their windows, the windows' shift in place, B and C in the scan's
layout, dt's softplus and ``a_log`` in f32) before ``ssd_scan``, and
``mamba2_gate_norm`` (the D-skip, the cast back, ``y * silu(z)`` and the
group norm) after it.  Every other step, the prefill and the forward run
their plain versions (``causal_conv``, ``split_bc`` and ``gated_norm``
live beside them in ``kernels/``).

Published Zamba2 (``cfg.published_hybrid``, zamba2-7b) reads B and C in
``cfg.ssm_groups`` groups (head h reads group ``h // (H / G)``; ``w_bc``
and the conv's B|C channels are ``[B_0 .. B_{G-1} | C_0 .. C_{G-1}]``),
adds a bias after each depthwise conv, and takes its gated norm per
group of ``d_inner / G`` channels.  One group is every other stack's
form, computed as before.  A leaf the model keeps in f32 (``a_log``,
``dt_bias``, ``d_skip``) may come in another type (the benchmark draws
every leaf in bf16); it is widened to f32 where it is used.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_conv_step.ops import (
    causal_conv, mamba2_conv_step, mamba2_conv_step_plain, split_bc)
from repro_torch.kernels.mamba2_gate_norm.ops import (
    gated_norm, mamba2_gate_norm, mamba2_gate_norm_plain)
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.models import sharding as sh
from repro_torch.models.common import (decode_linear, dense_init, keep_in,
                                       linear)


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    h, w = cfg.ssm_num_heads, cfg.ssm_conv_width
    gn = cfg.ssm_groups * n
    dev, f32 = gen.device, torch.float32
    p = {
        "w_zx": dense_init(gen, (d, 2 * di), dtype),
        "w_bc": dense_init(gen, (d, 2 * gn), dtype),
        "w_dt": dense_init(gen, (d, h), dtype),
        "dt_bias": torch.zeros(h, dtype=f32, device=dev),
        "a_log": torch.zeros(h, dtype=f32, device=dev),      # A = -exp(a_log)
        "d_skip": torch.ones(h, dtype=f32, device=dev),
        "conv_x": dense_init(gen, (w, di), dtype, fan_in=w),
        "conv_bc": dense_init(gen, (w, 2 * gn), dtype, fan_in=w),
        "norm": torch.zeros(di, dtype=dtype, device=dev),
        "w_out": dense_init(gen, (di, d), dtype, fan_in=di),
    }
    if cfg.published_hybrid:
        p["conv_x_bias"] = torch.zeros(di, dtype=dtype, device=dev)
        p["conv_bc_bias"] = torch.zeros(2 * gn, dtype=dtype, device=dev)
    return p


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
    reference's gradient NaN there (0 * inf).  Grouped b, c (B, S, G,
    N) run per group of heads.
    """
    if b.dim() == 4:
        g = b.shape[2]
        hg = x.shape[2] // g
        parts = [ssd_chunked(x[:, :, i * hg:(i + 1) * hg],
                             dt[:, :, i * hg:(i + 1) * hg],
                             a_log[i * hg:(i + 1) * hg], b[:, :, i], c[:, :, i],
                             chunk, None if h0 is None
                             else h0[:, i * hg:(i + 1) * hg])
                 for i in range(g)]
        return (torch.cat([y for y, _ in parts], dim=2),
                torch.cat([hf for _, hf in parts], dim=1))
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


def _per_rank(form, mesh, x, dt, a_log, b, c, h0):
    """``form(x, dt, a_log, b, c, h0) -> (y, h_final)`` (the scan or the
    chunked form, both independent per (batch, head)) on each rank's
    slice through ``local_map``: the batch over the data axes, the heads
    over ``model`` where they divide it."""
    dp = sh.dp_axes(mesh)
    heads = "model" if x.shape[2] % sh.axis_size(mesh, "model") == 0 \
        else None
    xs, st = (dp, None, heads, None), (dp, heads, None, None)
    bs = (dp, None, None)
    return sh.local_call(
        form, mesh, (xs, (dp, None, heads), (heads,), bs, bs,
                     None if h0 is None else st),
        [xs, st], x, dt, a_log, b, c, h0)


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
    y, h_final = _per_rank(
        lambda x, dt, a_log, b, c, h0: scan(
            x, dt, a_log, b.contiguous(), c.contiguous(), h0,
            y_dtype=y_dtype), mesh, x, dt, a_log, b, c, h0)
    if out is not None:
        out.copy_(h_final)
        h_final = out
    return y, h_final


def _convs(params, xin, bcin, state):
    """The two depthwise convs (with their biases where the layer has
    them): ``(xc, conv_x, bcc, conv_bc)``."""
    xc, conv_x = causal_conv(xin, params["conv_x"],
                             state["conv_x"] if state else None,
                             params.get("conv_x_bias"))
    bcc, conv_bc = causal_conv(bcin, params["conv_bc"],
                               state["conv_bc"] if state else None,
                               params.get("conv_bc_bias"))
    return xc, conv_x, bcc, conv_bc


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
    the reference's forward does, ``ssd_chunked`` (per rank under
    ``mesh``, as ``ssd``); otherwise through ``ssd`` (``kernel`` as
    there)."""
    b, s, _ = x.shape
    h, p = cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xin, bcin, dt = _in_proj(params, x, cfg)
    xc, conv_x, bcc, conv_bc = _convs(params, xin, bcin, state)
    bm, cm = split_bc(bcc, cfg.ssm_groups)
    a_log = params["a_log"].float()
    xh = sh.split_last(xc, h, p)
    h0 = state["h"] if state else None
    if train_form and mesh is not None:
        y, h_final = _per_rank(
            lambda x, dt, a_log, b, c, h0: ssd_chunked(x, dt, a_log, b, c,
                                                       h0=h0),
            mesh, xh, dt, a_log, bm, cm, h0)
    elif train_form:
        y, h_final = ssd_chunked(xh, dt, a_log, bm, cm, h0=h0)
    else:
        y, h_final = ssd(xh, dt, a_log, bm, cm, h0, kernel=kernel,
                         out=None if out is None else out["h"], mesh=mesh)
    skip = params["d_skip"][None, None, :, None].to(y.dtype)
    y = y + xh.float().to(y.dtype) * skip
    y = y.reshape(b, s, cfg.d_inner)
    y = gated_norm(y, z, params["norm"], cfg.ssm_groups, cfg.norm_eps)
    return linear(y, params["w_out"]), {
        "conv_x": keep_in(out, "conv_x", conv_x),
        "conv_bc": keep_in(out, "conv_bc", conv_bc), "h": h_final}


def mamba2_decode(params, x: torch.Tensor, cfg: ModelConfig, state: dict, *,
                  kernel: bool = False, out: Optional[dict] = None,
                  mesh=None, fused: bool = False):
    """Single-token recurrent step.  x: (B, 1, d_model); state and
    ``out`` as in :func:`mamba2_fwd`.  ``fused``
    (``transformer.fused_decode``'s route) runs the chains around the
    scan as the ``mamba2_conv_step`` and ``mamba2_gate_norm`` kernels,
    else as their plain versions, and the weight products as
    ``decode_linear``'s: the three in-projections one ``decode_gemm``
    launch, ``w_out`` another."""
    h, p, di = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.d_inner
    zx, bcin, dt_raw = decode_linear(x, params["w_zx"], params["w_bc"],
                                     params["w_dt"], fused=fused)
    conv = mamba2_conv_step if fused else mamba2_conv_step_plain
    xc, bm, cm, dt, a_log, conv_x, conv_bc = conv(
        params, zx[..., di:], bcin, dt_raw, state, cfg.ssm_groups, out)
    xh = sh.split_last(xc, h, p)
    y, h_new = ssd(xh, dt, a_log, bm, cm, state["h"], kernel=kernel,
                   out=None if out is None else out["h"],
                   y_dtype=torch.float32, mesh=mesh)
    gate = mamba2_gate_norm if fused else mamba2_gate_norm_plain
    y = gate(y, xh, params["d_skip"], zx[..., :di], params["norm"],
             cfg.ssm_groups, cfg.norm_eps)
    return decode_linear(y, params["w_out"], fused=fused), {
        "conv_x": conv_x, "conv_bc": conv_bc, "h": h_new}


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device,
                      layers: int):
    """Zero decode state of ``layers`` layers, each axis led by the layer:
    the reference's per-layer ``init_mamba2_state`` stacked."""
    di, n = cfg.d_inner, cfg.ssm_state_dim
    h, p, w = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_conv_width
    return {
        "conv_x": torch.zeros(layers, batch, w - 1, di, dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros(layers, batch, w - 1,
                               2 * cfg.ssm_groups * n, dtype=dtype,
                               device=device),
        "h": torch.zeros(layers, batch, h, p, n, dtype=torch.float32,
                         device=device),
    }
