"""Block assembly for the ``attn+mlp`` and ``rwkv6+rwkv_cm`` stacks:
prefill and decode.

Counterpart of those parts of ``repro.models.transformer``.  Prefill
attention runs the Hopper ``swa_prefill`` kernel when
``cfg.use_pallas_prefill`` is set (full causal attention is the case
``window = S``; the kernel masks ragged tiles itself, so the reference's
``S <= 256 or S % 256 == 0`` block guard is not needed), and its plain
PyTorch version otherwise.  The RWKV-6 time mix runs its WKV6 recurrence
on the ``rwkv6_scan`` kernel under ``cfg.use_pallas_prefill`` in prefill
and ``cfg.use_pallas_decode`` in decode.  ``cache`` is one layer's views
into the decode cache (``{"k", "v"}`` or ``{"tmix", "cmix"}``): prefill
fills it and decode updates it, in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swa_prefill.ops import (swa_prefill_attention,
                                                 swa_prefill_plain)
from repro_torch.models import attention as attn
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import linear, rms_norm
from repro_torch.models.mlp import init_mlp, mlp_fwd


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
               device):
    mixer, ffn = kind.split("+")
    d = cfg.d_model
    p = {"norm1": torch.zeros(d, dtype=dtype, device=device)}
    if mixer == "attn":
        p["attn"] = attn.init_attention(gen, cfg, dtype)
    elif mixer == "rwkv6":
        p["tmix"] = rk.init_rwkv6_tmix(gen, cfg, dtype)
    p["norm2"] = torch.zeros(d, dtype=dtype, device=device)
    if ffn == "mlp":
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype)
    elif ffn == "rwkv_cm":
        p["cmix"] = rk.init_rwkv6_cmix(gen, cfg, dtype)
    return p


def _write_kv_cache(k, v, cache: dict, window: int) -> None:
    """Write full-sequence K/V (B, S, KV, D) into cache[:, :S] in place
    (full attention: the cache holds at least S positions)."""
    if window > 0:
        raise NotImplementedError("the sliding-window ring buffer is not "
                                  "ported yet")
    s = k.shape[1]
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


def _ffn(p, h, cfg: ModelConfig, cache: dict, state):
    if "mlp" in p:
        return mlp_fwd(p["mlp"], h, cfg.mlp_kind)
    y, _ = rk.rwkv6_cmix_fwd(p["cmix"], h, cfg, state, out=cache["cmix"])
    return y


def block_prefill(p, x, positions, cfg: ModelConfig, cache: dict):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if "attn" in p:
        y = _attn_prefill(p["attn"], h, positions, cfg, 0, cache)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, None,
                                 kernel=cfg.use_pallas_prefill,
                                 out=cache["tmix"])
    x = x + y
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, None)


def block_decode(p, x, cache: dict, index: int, positions, cfg: ModelConfig):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if "attn" in p:
        y, _ = attn.attention_decode(p["attn"], h, cache, index, positions,
                                     cfg)
    else:
        y, _ = rk.rwkv6_tmix_fwd(p["tmix"], h, cfg, cache["tmix"],
                                 kernel=cfg.use_pallas_decode,
                                 out=cache["tmix"])
    x = x + y
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn(p, h, cfg, cache, cache.get("cmix"))
