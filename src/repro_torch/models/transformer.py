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
through ``attention.blocked_attention``, the Mamba2 and RWKV-6 mixers
through their kernels' plain versions; it returns the block's MoE
auxiliary loss beside its output, as the reference's does.  Prefill
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
``moe.moe_fwd``.  The RWKV-6 time mix runs its WKV6 recurrence
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
the attention as it is.
"""
from __future__ import annotations

from itertools import groupby
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.swa_prefill.ops import (swa_prefill_attention,
                                                 swa_prefill_plain)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import linear, rms_norm
from repro_torch.models.mlp import init_mlp, mlp_fwd
from repro_torch.models.moe import init_moe, moe_fwd


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
    positions."""
    s = k.shape[1]
    if window > 0:
        w = min(window, cache["k"].shape[1])
        take = min(s, w)
        slots = torch.arange(s - take, s, device=k.device) % w
        cache["k"].index_copy_(1, slots, k[:, s - take:].to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, v[:, s - take:].to(cache["v"].dtype))
        return
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)


def _attn_prefill(p, h, positions, cfg: ModelConfig, window: int,
                  cache: dict):
    """Attention forward over the prompt that also fills ``cache``."""
    b, s, _ = h.shape
    hh, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(h, p["wq"]).reshape(b, s, hh, d)
    k = linear(h, p["wk"]).reshape(b, s, kvh, d)
    v = linear(h, p["wv"]).reshape(b, s, kvh, d)
    q, k = attn._rope_qk(q, k, positions, cfg)
    w = window if window > 0 else s
    if cfg.use_pallas_prefill and cfg.logit_softcap == 0:
        out = swa_prefill_attention(q, k, v, window=w)
    elif cfg.rope_kind == "mrope":
        qp = attn.mask_positions(positions, cfg)
        out = attn.blocked_attention(q, k, v, qp, qp, causal=True,
                                     window=window, scale=d ** -0.5,
                                     cap=cfg.logit_softcap)
    else:
        out = swa_prefill_plain(q, k, v, window=w)
    y = linear(out.reshape(b, s, hh * d), p["wo"])
    _write_kv_cache(k, v, cache, window)
    return y


def _window(cfg: ModelConfig, mixer: str) -> int:
    """The attention window of a mixer: ``cfg.window_size`` for ``swa``,
    0 (full causal) for ``attn``."""
    return cfg.window_size if mixer == "swa" else 0


def _ffn(p, h, cfg: ModelConfig, cache, state):
    """The feed-forward half on the normed ``h``, ``(y, aux)`` (aux the
    MoE auxiliary loss, else 0.0); RWKV-6's channel mix keeps its token
    shift in ``cache["cmix"]`` (None: no cache)."""
    if "mlp" in p:
        return mlp_fwd(p["mlp"], h, cfg.mlp_kind), 0.0
    if "moe" in p:
        return moe_fwd(p["moe"], h, cfg)
    y, _ = rk.rwkv6_cmix_fwd(p["cmix"], h, cfg, state,
                             out=None if cache is None else cache["cmix"])
    return y, 0.0


def _cross_fwd(p, x, positions, enc_out, cfg: ModelConfig, kv=None):
    """Cross-attention over the encoder output (``kv``: its keys and
    values, when the caller has projected them already)."""
    h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
    return attn.attention_fwd(p["cross"], h, positions, cfg, causal=False,
                              kv_x=enc_out, kv=kv)


def _cross_decode(p, x, cache: dict, cfg: ModelConfig):
    """Cross-attention at decode over the encoder K/V of ``cache``
    (B, S_enc, KV, D), every row valid."""
    b = x.shape[0]
    hh, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
    q = linear(h, p["cross"]["wq"]).reshape(b, 1, hh, d)
    g = hh // kvh
    ck, cv = cache["k"], cache["v"]
    if cfg.use_pallas_decode:
        lengths = torch.full((b,), ck.shape[1], dtype=torch.int32,
                             device=x.device)
        out = decode_attention(q.reshape(b, kvh, g, d), ck, cv, lengths)
    else:
        qf = (q.reshape(b, kvh, g, d) * (d ** -0.5)).float()
        scores = torch.einsum("bkgd,bskd->bkgs", qf, ck.float())
        pr = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", pr, cv.float())
    out = out.reshape(b, 1, hh * d).to(x.dtype)
    return linear(out, p["cross"]["wo"])


# -- forward (no cache) ------------------------------------------------------

def block_fwd(p, x, positions, kind: str, cfg: ModelConfig, *,
              causal: bool = True, enc_out=None):
    """One block over the whole sequence, no cache; cross-attention over
    ``enc_out`` when the stack is an encoder-decoder's and it is given.
    Returns ``(x, aux)``, aux the block's MoE auxiliary loss (0.0
    without one)."""
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y = attn.attention_fwd(p["attn"], h, positions, cfg,
                               window=_window(cfg, mixer), causal=causal)
    elif mixer == "mla":
        y = attn.mla_fwd(p["mla"], h, positions, cfg)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None)
    x = x + y
    if cfg.is_encoder_decoder and enc_out is not None:
        x = x + _cross_fwd(p, x, positions, enc_out, cfg)
    if "norm2" not in p:                     # ffn "none"
        return x, 0.0
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = _ffn(p, h, cfg, None, None)
    return x + y, aux


# -- prefill and decode --------------------------------------------------------

def _mla_prefill(p, h, positions, cfg: ModelConfig, cache: dict):
    """MLA forward over the prompt that also writes its latent and rope
    keys into ``cache`` (rows 0..S-1)."""
    q_nope, q_rope, c_kv, k_rope = attn._mla_qkv(p, h, positions, cfg)
    y = attn.mla_attend(p, q_nope, q_rope, c_kv, k_rope, positions, cfg)
    s = h.shape[1]
    cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :s] = k_rope[:, :, 0].to(cache["k_rope"].dtype)
    return y


def block_prefill(p, x, positions, kind: str, cfg: ModelConfig, cache: dict,
                  enc_out=None):
    """One block over the prompt, filling the layer's ``cache``; with
    ``enc_out`` the encoder's K/V go into ``cache["cross"]``."""
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y = _attn_prefill(p["attn"], h, positions, cfg, _window(cfg, mixer),
                          cache)
    elif mixer == "mla":
        y = _mla_prefill(p["mla"], h, positions, cfg, cache)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None,
                             kernel=cfg.use_pallas_prefill, out=cache["ssm"])
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None,
                                 kernel=cfg.use_pallas_prefill,
                                 out=cache["tmix"])
    x = x + y
    if cfg.is_encoder_decoder and enc_out is not None:
        ck, cv = attn.project_kv(p["cross"], enc_out, cfg)
        cache["cross"]["k"].copy_(ck)
        cache["cross"]["v"].copy_(cv)
        x = x + _cross_fwd(p, x, positions, enc_out, cfg, kv=(ck, cv))
    if "norm2" not in p:                     # ffn "none"
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, None)[0]


def block_decode(p, x, cache: dict, index: torch.Tensor, positions,
                 kind: str, cfg: ModelConfig):
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y, _ = attn.attention_decode(p["attn"], h, cache, index, positions,
                                     cfg, window=_window(cfg, mixer))
    elif mixer == "mla":
        y, _ = attn.mla_decode(p["mla"], h, cache, index, positions, cfg)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_decode(p["mamba"], h, cfg, cache["ssm"],
                                kernel=cfg.use_pallas_decode,
                                out=cache["ssm"])
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, cache["tmix"],
                                 kernel=cfg.use_pallas_decode,
                                 out=cache["tmix"])
    x = x + y
    if cfg.is_encoder_decoder and "cross" in cache:
        x = x + _cross_decode(p, x, cache["cross"], cfg)
    if "norm2" not in p:                     # ffn "none"
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, cache.get("cmix"))[0]


# ---------------------------------------------------------------------------
# zamba2's shared attention block: one weight set, one ring-buffer KV cache
# per application (``cache`` is that application's {"k", "v"})
# ---------------------------------------------------------------------------

def shared_attn_fwd(p, x, positions, cfg: ModelConfig):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn.attention_fwd(p["attn"], h, positions, cfg,
                               window=cfg.shared_attn_window)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp_kind)


def shared_attn_prefill(p, x, positions, cfg: ModelConfig, cache: dict):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _attn_prefill(p["attn"], h, positions, cfg,
                          cfg.shared_attn_window, cache)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp_kind)


def shared_attn_decode(p, x, cache: dict, index: torch.Tensor, positions,
                       cfg: ModelConfig):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    y, _ = attn.attention_decode(p["attn"], h, cache, index, positions, cfg,
                                 window=cfg.shared_attn_window)
    x = x + y
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.mlp_kind)
