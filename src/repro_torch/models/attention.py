"""GQA attention: init, RoPE and M-RoPE, the no-cache forward (self-
and cross-attention), single-token decode against a KV cache.

Counterpart of the GQA part of ``repro.models.attention`` (MLA is still
to be ported).  ``attention_fwd`` is the forward over a whole sequence
with no cache, through ``blocked_attention``: the reference computes it
in plain array code outside any Pallas kernel, and so does this
counterpart; with ``kv_x`` it is cross-attention (no RoPE, not causal,
keys at positions 0..Sk-1 unless ``kv_positions`` says otherwise).
Under M-RoPE (``positions`` of shape (3, B, S)) the mask reads the
temporal ids ``positions[0]``, as the reference's does.  A
sliding-window cache (``window > 0``) is a ring buffer of
``min(seq, window)`` slots: slot ``p % S`` holds position ``p``.
``attention_decode`` routes through the Hopper ``decode_attention``
kernel when ``cfg.use_pallas_decode`` is set and the reference's guard
holds apart from its ``window == 0`` (no softcap, ``d % 8 == 0``);
otherwise it computes the reference's dense masked softmax.  The kernel
takes the ring buffer too, which the reference's kernel route does not:
a softmax does not depend on the order of its slots, and the
reference's mask ``(slot - j) % S <= index`` keeps exactly the slots
``j < min(index + 1, S)`` (before the first wrap slots ``0..index``,
after it every slot), which is the kernel's ``lengths`` mask.  The KV
cache is updated in place: the new token's K/V are written into its
slot of the given cache tensors.  The cache index is a 0-dim int32
tensor on the device: the slot, the mask and the kernel's ``lengths``
are computed from it there, so a decode step reads nothing back to the
host and one captured step serves every position.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                       linear, softcap)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype):
    h, kv, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": dense_init(gen, (dm, h * d), dtype),
        "wk": dense_init(gen, (dm, kv * d), dtype),
        "wv": dense_init(gen, (dm, kv * d), dtype),
        "wo": dense_init(gen, (h * d, dm), dtype, fan_in=h * d),
    }


def _rope_qk(q, k, positions, cfg: ModelConfig):
    """RoPE on q and k: standard over (B, S) positions, M-RoPE over
    (3, B, S) ids; ``learned`` and ``none`` leave them as they are."""
    if cfg.rope_kind == "standard":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k


def mask_positions(positions, cfg: ModelConfig):
    """The (B, S) positions the attention mask reads: the temporal ids
    under M-RoPE, else the positions themselves."""
    return positions[0] if cfg.rope_kind == "mrope" else positions


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int, scale: float,
                      cap: float = 0.0, block_q: int = 512,
                      block_k: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax attention in plain PyTorch, block for
    block the reference's.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D); q_pos / k_pos: (B, Sq) /
    (B, Sk).  Returns (B, Sq, H, D) in v's dtype.  Never materialises
    (Sq, Sk): queries go in blocks of ``block_q``, keys in blocks of
    ``block_k``, the sequences padded to whole blocks (padded queries at
    position -1, padded keys at 2**30 and masked).  ``cap > 0`` soft-caps
    the scores before the mask."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    orig_sq = sq
    pad_q = (-sq) % block_q
    pad_k = (-sk) % block_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
        sq += pad_q
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = F.pad(k_pos, (0, pad_k), value=2**30)
        sk += pad_k
    nq, nk = sq // block_q, sk // block_k

    qb = q.reshape(b, nq, block_q, kvh, g, d).permute(1, 0, 3, 4, 2, 5)
    # qb: (nq, B, KV, G, bq, D)
    qpb = q_pos.reshape(b, nq, block_q).permute(1, 0, 2)       # (nq, B, bq)
    kb = k.reshape(b, nk, block_k, kvh, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, block_k, kvh, dv).permute(1, 0, 3, 2, 4)
    kpb = k_pos.reshape(b, nk, block_k).permute(1, 0, 2)       # (nk, B, bk)

    outs = []
    for qi, qp in zip(qb, qpb):              # (B,KV,G,bq,D), (B,bq)
        qi = qi.float() * scale
        m = torch.full((b, kvh, g, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, block_q), device=q.device)
        acc = torch.zeros((b, kvh, g, block_q, dv), device=q.device)
        for ki, vi, kp in zip(kb, vb, kpb):  # (B,KV,bk,D) x2, (B,bk)
            s = torch.einsum("bkgqd,bktd->bkgqt", qi, ki.float())
            if cap > 0:
                s = softcap(s, cap)
            rel = qp[:, None, None, :, None] - kp[:, None, None, None, :]
            mask = (kp < 2**30)[:, None, None, None, :]
            if causal:
                mask = mask & (rel >= 0)
            if window > 0:
                mask = mask & (rel < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bktd->bkgqd", p, vi.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])

    out = torch.stack(outs)                  # (nq, B, KV, G, bq, Dv)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, dv)
    return out[:, :orig_sq].to(v.dtype)


def project_kv(params, src: torch.Tensor, cfg: ModelConfig):
    """Keys and values of ``src`` (B, Sk, d_model), each (B, Sk, KV, D),
    before any RoPE."""
    kvh, d = cfg.num_kv_heads, cfg.head_dim
    b, sk, _ = src.shape
    return (linear(src, params["wk"]).reshape(b, sk, kvh, d),
            linear(src, params["wv"]).reshape(b, sk, kvh, d))


def attention_fwd(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, window: int = 0, causal: bool = True,
                  kv_x: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None,
                  kv=None) -> torch.Tensor:
    """Attention over a whole sequence, no cache.  x: (B, S, d_model);
    positions: (B, S), or (3, B, S) under M-RoPE.  ``window > 0`` keeps
    the keys of the last ``window`` positions (sliding window).  With
    ``kv_x`` (B, Sk, d_model) it is cross-attention: keys and values
    from ``kv_x``, no RoPE and no causal mask; ``kv`` is
    ``project_kv(params, kv_x, cfg)`` when the caller has it already."""
    h, d = cfg.num_heads, cfg.head_dim
    b, s, _ = x.shape
    src = kv_x if kv_x is not None else x
    sk = src.shape[1]
    q = linear(x, params["wq"]).reshape(b, s, h, d)
    k, v = kv if kv is not None else project_kv(params, src, cfg)
    if kv_x is None:
        q, k = _rope_qk(q, k, positions, cfg)
    qp = mask_positions(positions, cfg)
    if kv_x is not None:
        kp = kv_positions
        if kp is None:
            kp = torch.arange(sk, device=x.device).expand(b, sk)
    else:
        kp = qp
    out = blocked_attention(q, k, v, qp, kp, causal=causal and kv_x is None,
                            window=window, scale=d ** -0.5,
                            cap=cfg.logit_softcap)
    return linear(out.reshape(b, s, h * d), params["wo"])


def attention_decode(params, x: torch.Tensor, cache: dict, cache_index,
                     positions: torch.Tensor, cfg: ModelConfig, *,
                     window: int = 0):
    """Single-token decode.  x: (B, 1, d_model); cache: {"k", "v"} of
    (B, S, KV, D), keys cached post-RoPE; ``cache_index`` (a 0-dim
    integer tensor, or an int) is the position of this token.  Writes
    the token's K/V into the cache in place and returns ``(y, cache)``.
    ``positions``: (B, 1), or (3, B, 1) under M-RoPE.  With ``window >
    0`` the cache is a ring buffer and the token goes to slot
    ``cache_index % S``."""
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = x.shape[0]
    q = linear(x, params["wq"]).reshape(b, 1, h, d)
    k = linear(x, params["wk"]).reshape(b, 1, kvh, d)
    v = linear(x, params["wv"]).reshape(b, 1, kvh, d)
    q, k = _rope_qk(q, k, positions, cfg)

    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    index = torch.as_tensor(cache_index, device=x.device).long()
    slot = index % s_cache if window > 0 else index
    ck.index_copy_(1, slot.view(1), k.to(ck.dtype))
    cv.index_copy_(1, slot.view(1), v.to(cv.dtype))

    g = h // kvh
    if cfg.use_pallas_decode and cfg.logit_softcap == 0 and d % 8 == 0:
        # Hopper flash-decode kernel over the valid slots [0, lengths)
        lengths = torch.clamp(index + 1, max=s_cache).to(torch.int32)
        out = decode_attention(q.reshape(b, kvh, g, d), ck, cv,
                               lengths.expand(b).contiguous())
        out = out.reshape(b, 1, h * d).to(x.dtype)
        return linear(out, params["wo"]), cache
    j = torch.arange(s_cache, device=x.device)
    if window > 0:
        # ring buffer: slot j holds position index - ((slot - j) mod S)
        valid = (slot - j) % s_cache <= index
    else:
        valid = j <= index
    qf = (q.reshape(b, kvh, g, d) * (d ** -0.5)).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, ck.float())
    if cfg.logit_softcap > 0:
        scores = softcap(scores, cfg.logit_softcap)
    scores = scores.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    out = out.reshape(b, 1, h * d).to(x.dtype)
    return linear(out, params["wo"]), cache


def init_attention_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
                         device, *, layers: int = 1, window: int = 0):
    """Zeroed K/V cache of ``layers`` stacked (B, S, KV, D) buffers, with
    S = ``min(seq, window)`` for a sliding window, else ``seq``."""
    s = min(seq, window) if window > 0 else seq
    shape = (layers, batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
