"""Block assembly for the ``attn+mlp``, ``swa+mlp``, ``attn+moe``,
``mla+mlp``, ``mla+moe``, ``rwkv6+rwkv_cm`` and ``mamba2+none`` stacks,
zamba2's shared attention block and whisper's cross-attention: the
no-cache forward, prefill and decode.

Counterpart of ``repro.models.transformer``.  A model is a sequence of
homogeneous groups of blocks (``layer_groups``: kimi-k2 is one
``attn+mlp`` layer then ``attn+moe`` layers, deepseek-v3 ``mla+mlp``
then ``mla+moe``); the port runs them as one Python loop over layers,
each with its own kind.  An ``swa``
mixer is attention over the last ``cfg.window_size`` positions (its
cache a ring buffer), an ``attn`` mixer full causal attention (or, for
whisper's encoder, bidirectional: ``causal=False``).  The
forward (``block_fwd``) runs the reference's plain paths: attention
through ``attention.blocked_attention``, the Mamba2 mixer through the
chunked form ``mamba2.ssd_chunked`` and the RWKV-6 time mix through
the reference's WKV6 recurrence (``rwkv6.wkv6_recurrence``), or
``rwkv6.wkv6_chunked`` under ``cfg.rwkv_chunked``, as the reference's;
it returns the block's MoE auxiliary loss beside its output, as the
reference's does.  Prefill
attention runs the Hopper ``swa_prefill`` kernel when
``cfg.use_pallas_prefill`` is set (full causal attention is the case
``window = S``; the kernel masks ragged tiles itself, so the reference's
``S <= 256 or S % 256 == 0`` block guard is not needed), and its plain
PyTorch version otherwise.  The kernel, as the reference's Pallas
kernel, is causal in sequence order; the reference's plain route masks
by the positions, which under M-RoPE are the temporal ids and may
repeat (all patches of one image share t = 0), so the plain route of an
M-RoPE stack is ``blocked_attention`` over those ids, as there.  An MLA
mixer runs the reference's forms on every route (``blocked_attention``
over the materialised K/V in prefill, the absorbed latent attention at
decode: ``attention.mla_*``), an ``moe`` feed-forward the single-shard
``moe.moe_fwd`` (under a mesh the expert-parallel ``moe.moe_fwd_ep``).  The RWKV-6 time mix runs its WKV6 recurrence
on the ``rwkv6_scan`` kernel and the Mamba2 mixer its SSD recurrence on
the ``ssd_scan`` kernel, under ``cfg.use_pallas_prefill`` in prefill and
``cfg.use_pallas_decode`` in decode.  Whisper's cross-attention reads
the encoder output: in the forward and the prefill through
``blocked_attention`` (not causal, outside any kernel, as the
reference's), and at decode over the encoder K/V that the prefill wrote
into the layer's ``cache["cross"]``, through ``decode_attention`` with
every row valid under ``cfg.use_pallas_decode`` (the reference computes
it as a dense softmax, the plain route here).  ``cache`` is one layer's views
into the decode cache (``{"k", "v"[, "cross"]}``, ``{"c_kv",
"k_rope"}``, ``{"tmix", "cmix"}`` or ``{"ssm"}``), or one shared-block
application's ``{"k", "v"}`` ring
buffer: prefill fills it and decode updates it, in place.  A decode
step's ``index`` is the cache's 0-dim int32 index tensor, passed on to
the attention as it is.  At decode a block does not add its last
output to the residual: it returns ``(x, y)`` and the next block's
first norm (or the final norm) adds them, so that each add is one pass
with its norm.  bf16 decode on the card without a mesh
(``fused_decode``) runs those norms as the ``add_rms_norm`` kernel,
standard RoPE with the K/V write as ``rope_kv_write``, a SwiGLU /
GeGLU gate as ``glu_gate`` and a Mamba2 mixer's chains around its scan
as ``mamba2_conv_step`` and ``mamba2_gate_norm``; every other step runs
their plain chains.
Every block function takes ``mesh``: the attention cores (the kernels
too), the scans and the cache writes then run per rank on DTensor
inputs (``attention.attention_core`` / ``decode_core``,
``sharding.write_rows``), the rest on DTensors.
"""
from __future__ import annotations

from itertools import groupby
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.add_rms_norm.ops import (add_rms_norm,
                                                  add_rms_norm_plain)
from repro_torch.kernels.swa_prefill.ops import (swa_prefill_attention,
                                                 swa_prefill_plain)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models import sharding as sh
from repro_torch.models.common import linear, rms_norm
from repro_torch.models.mlp import init_mlp, mlp_fwd
from repro_torch.models.moe import init_moe, moe_fwd, moe_fwd_ep


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    return [(kind, len(list(g))) for kind, g in groupby(cfg.blocks)]


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device, experts: Optional[Tuple[int, int]] = None):
    """One block's parameters; an ``moe`` block holds the experts
    ``experts = (e_lo, e_local)`` (all when None) and, when they start
    at expert 0, the shared expert (``moe.init_moe``)."""
    mixer, ffn = kind.split("+")
    d = cfg.d_model
    p = {"norm1": torch.zeros(d, dtype=dtype, device=device)}
    if mixer in ("attn", "swa"):
        p["attn"] = attn.init_attention(gen, cfg, dtype)
    elif mixer == "mla":
        p["mla"] = attn.init_mla(gen, cfg, dtype)
    elif mixer == "mamba2":
        p["mamba"] = m2.init_mamba2(gen, cfg, dtype)
    elif mixer == "rwkv6":
        p["tmix"] = rk.init_rwkv6_tmix(gen, cfg, dtype)
    if ffn != "none":
        p["norm2"] = torch.zeros(d, dtype=dtype, device=device)
    if ffn == "mlp":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype)
    elif ffn == "moe":
        p["moe"] = init_moe(gen, cfg, dtype, experts)
    elif ffn == "rwkv_cm":
        p["cmix"] = rk.init_rwkv6_cmix(gen, cfg, dtype)
    if cfg.is_encoder_decoder:
        p["norm_cross"] = torch.zeros(d, dtype=dtype, device=device)
        p["cross"] = attn.init_attention(gen, cfg, dtype)
    return p


def init_shared_attn(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    """Zamba2's shared attention + MLP block: one weight set for every
    application."""
    d = cfg.d_model
    return {"norm1": torch.zeros(d, dtype=dtype, device=device),
            "attn": attn.init_attention(gen, cfg, dtype),
            "norm2": torch.zeros(d, dtype=dtype, device=device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype)}


def _write_kv_cache(k, v, cache: dict, window: int) -> None:
    """Write full-sequence K/V (B, S, KV, D) into the (zeroed) cache in
    place.  Full attention: cache[:, :S] (the cache holds at least S
    positions).  Sliding window: a ring buffer of w = min(window, cache
    size) slots, slot p % w holding position p, for the last min(S, w)
    positions.  A DTensor cache is written per rank
    (``sharding.write_rows``)."""
    s = k.shape[1]
    if window > 0:
        w = min(window, cache["k"].shape[1])
        take = min(s, w)
        slots = torch.arange(s - take, s, device=k.device) % w
        sh.write_rows(cache["k"], 1, slots, k[:, s - take:])
        sh.write_rows(cache["v"], 1, slots, v[:, s - take:])
        return
    if not sh.is_dtensor(cache["k"]):
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        return
    slots = torch.arange(s, device=k.device)
    sh.write_rows(cache["k"], 1, slots, k)
    sh.write_rows(cache["v"], 1, slots, v)


def _attn_prefill(p, h, positions, cfg: ModelConfig, window: int,
                  cache: dict, mesh=None):
    """Attention forward over the prompt that also fills ``cache``; under
    ``mesh`` the attention core runs per rank (``attention_core``), on
    the kernel too."""
    b, s, _ = h.shape
    hh, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = sh.split_last(linear(h, p["wq"]), hh, d)
    k = sh.split_last(linear(h, p["wk"]), kvh, d)
    v = sh.split_last(linear(h, p["wv"]), kvh, d)
    q, k = attn._rope_qk(q, k, positions, cfg)
    w = window if window > 0 else s
    bp_axes = (attn._bp_spec(mesh, b)
               if (mesh is not None and cfg.attn_batch_parallel) else None)
    if cfg.use_pallas_prefill and cfg.logit_softcap == 0:
        out = attn.attention_core(
            lambda q, k, v: swa_prefill_attention(q, k, v, window=w,
                                                  scale=cfg.softmax_scale),
            mesh, q, k, v, bp_axes=bp_axes)
    elif cfg.rope_kind == "mrope":
        qp = attn.mask_positions(positions, cfg)
        out = attn.attention_core(
            lambda q, k, v, qp: attn.blocked_attention(
                q, k, v, qp, qp, causal=True, window=window,
                scale=d ** -0.5, cap=cfg.logit_softcap),
            mesh, q, k, v, qp, bp_axes=bp_axes, rest_specs=("pos",))
    else:
        out = attn.attention_core(
            lambda q, k, v: swa_prefill_plain(q, k, v, window=w,
                                              scale=cfg.softmax_scale),
            mesh, q, k, v, bp_axes=bp_axes)
    y = linear(out.reshape(b, s, hh * d), p["wo"])
    _write_kv_cache(k, v, cache, window)
    return y


def _window(cfg: ModelConfig, mixer: str) -> int:
    """The attention window of a mixer: ``cfg.window_size`` for ``swa``,
    0 (full causal) for ``attn``."""
    return cfg.window_size if mixer == "swa" else 0


def _ffn(p, h, cfg: ModelConfig, cache, state, mesh=None,
         fused: bool = False):
    """The feed-forward half on the normed ``h``, ``(y, aux)`` (aux the
    MoE auxiliary loss, else 0.0); RWKV-6's channel mix keeps its token
    shift in ``cache["cmix"]`` (None: no cache).  Under ``mesh`` an MoE
    runs expert-parallel (``moe_fwd_ep``); under ``fused`` an MLP's gate
    is the ``glu_gate`` kernel."""
    if "mlp" in p:
        return mlp_fwd(p["mlp"], h, cfg.mlp_kind, fused), 0.0
    if "moe" in p:
        if mesh is not None:
            return moe_fwd_ep(p["moe"], h, cfg, mesh, sh.dp_axes(mesh),
                              "model")
        return moe_fwd(p["moe"], h, cfg)
    y, _ = rk.rwkv6_cmix_fwd(p["cmix"], h, cfg, state,
                             out=None if cache is None else cache["cmix"])
    return y, 0.0


def _cross_fwd(p, x, positions, enc_out, cfg: ModelConfig, kv=None,
               mesh=None):
    """Cross-attention over the encoder output (``kv``: its keys and
    values, when the caller has projected them already)."""
    h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
    return attn.attention_fwd(p["cross"], h, positions, cfg, causal=False,
                              kv_x=enc_out, kv=kv, mesh=mesh)


def _cross_decode(p, h, cache: dict, cfg: ModelConfig, mesh=None):
    """Cross-attention at decode of the normed ``h`` over the encoder K/V
    of ``cache`` (B, S_enc, KV, D), every row valid
    (``attention.decode_core``)."""
    b = h.shape[0]
    hh, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = sh.split_last(linear(h, p["cross"]["wq"]), hh, d)
    ck, cv = cache["k"], cache["v"]
    s_enc = ck.shape[1]
    # a fill on the device, not a copy from the host: a captured step
    # may hold it
    last = torch.full((), s_enc - 1, dtype=torch.long, device=h.device)
    q = sh.fit_dim(q, 2, kvh)
    out = attn.decode_core(
        q.reshape(b, kvh, hh // kvh, d), ck, cv, last, cfg, window=0,
        mesh=mesh, lengths=torch.full((b,), s_enc, dtype=torch.int32,
                                      device=h.device))
    out = out.reshape(b, 1, hh * d).to(h.dtype)
    return linear(out, p["cross"]["wo"])


# -- forward (no cache) ------------------------------------------------------

def block_fwd(p, x, positions, kind: str, cfg: ModelConfig, *,
              causal: bool = True, enc_out=None, mesh=None):
    """One block over the whole sequence, no cache; cross-attention over
    ``enc_out`` when the stack is an encoder-decoder's and it is given.
    Returns ``(x, aux)``, aux the block's MoE auxiliary loss (0.0
    without one).  ``mesh``: the attention cores run per rank and an
    MoE expert-parallel."""
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y = attn.attention_fwd(p["attn"], h, positions, cfg,
                               window=_window(cfg, mixer), causal=causal,
                               mesh=mesh)
    elif mixer == "mla":
        y = attn.mla_fwd(p["mla"], h, positions, cfg, mesh=mesh)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None, train_form=True,
                             mesh=mesh)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None, train_form=True,
                                 mesh=mesh)
    x = x + y
    if cfg.is_encoder_decoder and enc_out is not None:
        x = x + _cross_fwd(p, x, positions, enc_out, cfg, mesh=mesh)
    if "norm2" not in p:                     # ffn "none"
        return x, 0.0
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _ffn(p, h, cfg, None, None, mesh)
    return x + y, aux


# -- prefill and decode --------------------------------------------------------

def _mla_prefill(p, h, positions, cfg: ModelConfig, cache: dict,
                 mesh=None):
    """MLA forward over the prompt that also writes its latent and rope
    keys into ``cache`` (rows 0..S-1)."""
    q_nope, q_rope, c_kv, k_rope = attn._mla_qkv(p, h, positions, cfg)
    y = attn.mla_attend(p, q_nope, q_rope, c_kv, k_rope, positions, cfg,
                        mesh=mesh)
    slots = torch.arange(h.shape[1], device=h.device)
    sh.write_rows(cache["c_kv"], 1, slots, c_kv)
    sh.write_rows(cache["k_rope"], 1, slots, k_rope[:, :, 0])
    return y


def block_prefill(p, x, positions, kind: str, cfg: ModelConfig, cache: dict,
                  enc_out=None, mesh=None):
    """One block over the prompt, filling the layer's ``cache``; with
    ``enc_out`` the encoder's K/V go into ``cache["cross"]``.  ``mesh``
    as in ``block_fwd``; the scans run per rank too."""
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y = _attn_prefill(p["attn"], h, positions, cfg, _window(cfg, mixer),
                          cache, mesh)
    elif mixer == "mla":
        y = _mla_prefill(p["mla"], h, positions, cfg, cache, mesh)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None,
                             kernel=cfg.use_pallas_prefill, out=cache["ssm"],
                             mesh=mesh)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None,
                                 kernel=cfg.use_pallas_prefill,
                                 out=cache["tmix"], mesh=mesh)
    x = x + y
    if cfg.is_encoder_decoder and enc_out is not None:
        ck, cv = attn.project_kv(p["cross"], enc_out, cfg)
        rows = torch.arange(ck.shape[1], device=x.device)
        sh.write_rows(cache["cross"]["k"], 1, rows, ck)
        sh.write_rows(cache["cross"]["v"], 1, rows, cv)
        x = x + _cross_fwd(p, x, positions, enc_out, cfg, kv=(ck, cv),
                           mesh=mesh)
    if "norm2" not in p:                     # ffn "none"
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, None, mesh)[0]


def fused_decode(cfg: ModelConfig, x: torch.Tensor, mesh=None) -> bool:
    """Whether a decode step over the residual ``x`` takes the fused
    kernels (``add_rms_norm`` for its norms, ``rope_kv_write`` for
    standard RoPE and the KV write, ``glu_gate`` for a SwiGLU / GeGLU
    gate, and a Mamba2 mixer's ``mamba2_conv_step`` before its scan and
    ``mamba2_gate_norm`` after it): on the kernel route
    (``cfg.use_pallas_decode``), bf16 on a CUDA device, no mesh (no
    DTensor).  Everything else (the CPU, f32, a mesh, prefill, the
    forward) runs the plain chains."""
    return (cfg.use_pallas_decode and mesh is None
            and x.device.type == "cuda" and x.dtype == torch.bfloat16)


def add_norm(x, y, scale, cfg: ModelConfig, fused: bool):
    """``(x + y, rms_norm(x + y))`` (``y`` None: no add): the
    ``add_rms_norm`` kernel under ``fused``, else its plain chain."""
    norm = add_rms_norm if fused else add_rms_norm_plain
    return norm(x, y, scale, cfg.norm_eps)


def block_decode(p, x, cache: dict, index: torch.Tensor, positions,
                 kind: str, cfg: ModelConfig, mesh=None, y=None,
                 fused: bool = False, lengths=None):
    """One block at one decode token.  The residual arrives as ``x`` and
    the previous block's output ``y`` not yet added to it (None: ``x`` is
    all of it), so that the add is the first norm's; the block returns
    its own ``(x, y)`` likewise, and the next block's first norm, or the
    final norm, adds them.  ``fused``: ``fused_decode``'s route;
    ``lengths``: ``decode_attention``'s valid rows, computed once a
    step."""
    mixer = kind.split("+")[0]
    x, h = add_norm(x, y, p["norm1"], cfg, fused)
    if mixer in ("attn", "swa"):
        y, _ = attn.attention_decode(p["attn"], h, cache, index, positions,
                                     cfg, window=_window(cfg, mixer),
                                     mesh=mesh, fused=fused, lengths=lengths)
    elif mixer == "mla":
        y, _ = attn.mla_decode(p["mla"], h, cache, index, positions, cfg)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_decode(p["mamba"], h, cfg, cache["ssm"],
                                kernel=cfg.use_pallas_decode,
                                out=cache["ssm"], mesh=mesh, fused=fused)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, cache["tmix"],
                                 kernel=cfg.use_pallas_decode,
                                 out=cache["tmix"], mesh=mesh)
    if cfg.is_encoder_decoder and "cross" in cache:
        x, h = add_norm(x, y, p["norm_cross"], cfg, fused)
        y = _cross_decode(p, h, cache["cross"], cfg, mesh)
    if "norm2" not in p:                     # ffn "none"
        return x, y
    x, h = add_norm(x, y, p["norm2"], cfg, fused)
    return x, _ffn(p, h, cfg, cache, cache.get("cmix"), mesh, fused)[0]


# ---------------------------------------------------------------------------
# zamba2's shared attention block: one weight set, one ring-buffer KV cache
# per application (``cache`` is that application's {"k", "v"})
# ---------------------------------------------------------------------------

def shared_attn_fwd(p, x, positions, cfg: ModelConfig, mesh=None):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn.attention_fwd(p["attn"], h, positions, cfg,
                               window=cfg.shared_attn_window, mesh=mesh)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp_kind)


def shared_attn_prefill(p, x, positions, cfg: ModelConfig, cache: dict,
                        mesh=None):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _attn_prefill(p["attn"], h, positions, cfg,
                          cfg.shared_attn_window, cache, mesh)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp_kind)


def shared_attn_decode(p, x, cache: dict, index: torch.Tensor, positions,
                       cfg: ModelConfig, mesh=None, y=None,
                       fused: bool = False, lengths=None):
    """The shared block at one decode token: ``(x, y)`` in and out, as
    ``block_decode``."""
    x, h = add_norm(x, y, p["norm1"], cfg, fused)
    y, _ = attn.attention_decode(p["attn"], h, cache, index, positions, cfg,
                                 window=cfg.shared_attn_window, mesh=mesh,
                                 fused=fused, lengths=lengths)
    x, h = add_norm(x, y, p["norm2"], cfg, fused)
    return x, mlp_fwd(p["mlp"], h, cfg.mlp_kind, fused)
