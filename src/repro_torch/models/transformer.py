"""Block assembly for the ``attn+mlp``, ``swa+mlp``, ``rwkv6+rwkv_cm``
and ``mamba2+none`` stacks and zamba2's shared attention block: the
no-cache forward, prefill and decode.

Counterpart of those parts of ``repro.models.transformer``.  An ``swa``
mixer is attention over the last ``cfg.window_size`` positions (its
cache a ring buffer), an ``attn`` mixer full causal attention.  The
forward (``block_fwd``) runs the reference's plain paths: attention
through ``attention.blocked_attention``, the Mamba2 and RWKV-6 mixers
through their kernels' plain versions.  Prefill
attention runs the Hopper ``swa_prefill`` kernel when
``cfg.use_pallas_prefill`` is set (full causal attention is the case
``window = S``; the kernel masks ragged tiles itself, so the reference's
``S <= 256 or S % 256 == 0`` block guard is not needed), and its plain
PyTorch version otherwise.  The RWKV-6 time mix runs its WKV6 recurrence
on the ``rwkv6_scan`` kernel and the Mamba2 mixer its SSD recurrence on
the ``ssd_scan`` kernel, under ``cfg.use_pallas_prefill`` in prefill and
``cfg.use_pallas_decode`` in decode.  ``cache`` is one layer's views
into the decode cache (``{"k", "v"}``, ``{"tmix", "cmix"}`` or
``{"ssm"}``), or one shared-block application's ``{"k", "v"}`` ring
buffer: prefill fills it and decode updates it, in place.  A decode
step's ``index`` is the cache's 0-dim int32 index tensor, passed on to
the attention as it is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swa_prefill.ops import (swa_prefill_attention,
                                                 swa_prefill_plain)
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import linear, rms_norm
from repro_torch.models.mlp import init_mlp, mlp_fwd


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device):
    mixer, ffn = kind.split("+")
    d = cfg.d_model
    p = {"norm1": torch.zeros(d, dtype=dtype, device=device)}
    if mixer in ("attn", "swa"):
        p["attn"] = attn.init_attention(gen, cfg, dtype)
    elif mixer == "mamba2":
        p["mamba"] = m2.init_mamba2(gen, cfg, dtype)
    elif mixer == "rwkv6":
        p["tmix"] = rk.init_rwkv6_tmix(gen, cfg, dtype)
    if ffn != "none":
        p["norm2"] = torch.zeros(d, dtype=dtype, device=device)
    if ffn == "mlp":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype)
    elif ffn == "rwkv_cm":
        p["cmix"] = rk.init_rwkv6_cmix(gen, cfg, dtype)
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
    """The feed-forward half on the normed ``h``; RWKV-6's channel mix
    keeps its token shift in ``cache["cmix"]`` (None: no cache)."""
    if "mlp" in p:
        return mlp_fwd(p["mlp"], h, cfg.mlp_kind)
    y, _ = rk.rwkv6_cmix_fwd(p["cmix"], h, cfg, state,
                             out=None if cache is None else cache["cmix"])
    return y


# -- forward (no cache) ------------------------------------------------------

def block_fwd(p, x, positions, kind: str, cfg: ModelConfig):
    """One block over the whole sequence, no cache (the reference's
    ``block_fwd`` without MoE, MLA or cross-attention)."""
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y = attn.attention_fwd(p["attn"], h, positions, cfg,
                               window=_window(cfg, mixer))
    elif mixer == "mamba2":
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None)
    x = x + y
    if "norm2" not in p:                     # ffn "none"
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, None, None)


# -- prefill and decode --------------------------------------------------------

def block_prefill(p, x, positions, kind: str, cfg: ModelConfig, cache: dict):
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y = _attn_prefill(p["attn"], h, positions, cfg, _window(cfg, mixer),
                          cache)
    elif mixer == "mamba2":
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None,
                             kernel=cfg.use_pallas_prefill, out=cache["ssm"])
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None,
                                 kernel=cfg.use_pallas_prefill,
                                 out=cache["tmix"])
    x = x + y
    if "norm2" not in p:                     # ffn "none"
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, None)


def block_decode(p, x, cache: dict, index: torch.Tensor, positions,
                 kind: str, cfg: ModelConfig):
    mixer = kind.split("+")[0]
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer in ("attn", "swa"):
        y, _ = attn.attention_decode(p["attn"], h, cache, index, positions,
                                     cfg, window=_window(cfg, mixer))
    elif mixer == "mamba2":
        y, _ = m2.mamba2_decode(p["mamba"], h, cfg, cache["ssm"],
                                kernel=cfg.use_pallas_decode,
                                out=cache["ssm"])
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, cache["tmix"],
                                 kernel=cfg.use_pallas_decode,
                                 out=cache["tmix"])
    x = x + y
    if "norm2" not in p:                     # ffn "none"
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, cache.get("cmix"))


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
