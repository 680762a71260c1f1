"""Attention mixers: GQA with RoPE and M-RoPE, the no-cache forward
(self- and cross-attention), single-token decode against a KV cache,
and DeepSeek's multi-head latent attention (MLA).

Counterpart of ``repro.models.attention``.  ``attention_fwd`` is the forward over a whole sequence
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

MLA (``init_mla``, ``mla_fwd``, ``mla_decode``, ``init_mla_cache``)
keeps the reference's forms: the forward materialises per-head K/V
from the latent and runs ``blocked_attention`` (q and k of
``qk_nope_dim + qk_rope_dim``, v of ``v_head_dim``: neither Hopper
kernel takes two head dims, and the reference computes it outside any
Pallas kernel too); decode attends in the compressed latent space with
``w_uk`` absorbed into the query, in plain PyTorch as the reference's
einsums.  Its cache, ``{"c_kv": (B, S, kv_lora_rank), "k_rope": (B, S,
qk_rope_dim)}``, is written in place at the device index.

Under a mesh (``mesh=``, the reference's ``mesh`` and
``attn_batch_parallel``) the attention core runs per rank through
``local_map`` (``attention_core``, ``decode_core``): q, k and v (or the
cache) are placed with their batch over the data axes and their heads
over ``model`` where both head counts divide it, else replicated over
``model`` (as the reference's GSPMD runs it), or with the batch over
every axis under ``cfg.attn_batch_parallel`` (``_bp_spec``), and each
rank calls the kernel, or its plain version on the CPU, on its local
tensors: a DTensor never reaches a kernel wrapper.  A cache whose
sequence dim is sharded (``cache_specs(seq_shard=True)``), a ring
buffer too, is attended by each rank over its own rows, with the plain
partial softmax or with the kernel (which also returns each row's
log-sum-exp), and the ranks' parts are merged with two all-reduces
(``_decode_seq_sharded``); the reference's GSPMD gathers the cache
instead.  Cache writes land on the rank that holds the row
(``sharding.write_rows``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.rope_kv_write.ops import rope_kv_write
from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.models import sharding as sh
from repro_torch.models.common import (apply_mrope, apply_rope,
                                       decode_linear, dense_init, linear,
                                       rms_norm, softcap)

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
    return (sh.split_last(linear(src, params["wk"]), kvh, d),
            sh.split_last(linear(src, params["wv"]), kvh, d))


def _bp_spec(mesh, batch: int):
    """Widest mesh-axes tuple that divides the batch (for batch-parallel
    attention: shard the batch over the model axis too -- archs whose
    head counts don't divide the model axis otherwise run attention
    replicated n_model times)."""
    names = list(axis_names(mesh))
    sizes = axis_sizes(mesh)
    for axes in (tuple(names), tuple(a for a in names if a != "pod")):
        n = 1
        for a in axes:
            n *= sizes[a]
        if axes and batch % n == 0:
            return axes
    return None


def _bp_constrain(x, mesh, axes):
    """``x`` with its batch (dim 0) over ``axes``, every other dim whole."""
    return sh.constrain(x, mesh, (axes,) + (None,) * (x.ndim - 1))


def core_specs(mesh, b: int, h: int, kvh: int, bp_axes=None):
    """Specs of (q (B, S, H, D), k/v (B, S, KV, D), positions (B, S)) for
    an attention core run per rank: the batch over the data axes and the
    heads over ``model`` where both head counts divide it, else
    replicated over ``model`` (the reference's GSPMD runs it so); under
    ``bp_axes`` the batch over those axes and every head on each rank."""
    if bp_axes:
        return ((bp_axes, None, None, None), (bp_axes, None, None, None),
                (bp_axes, None))
    dp = tuple(a for a in sh.FSDP if a in axis_names(mesh))
    n_model = axis_sizes(mesh).get("model", 1)
    heads = "model" if h % n_model == 0 and kvh % n_model == 0 else None
    return ((dp, None, heads, None), (dp, None, heads, None), (dp, None))


def attention_core(fn, mesh, q, k, v, *rest, bp_axes=None, rest_specs=()):
    """``fn(q, k, v, *rest)`` -- an attention over (B, S, H, D) queries
    and (B, Sk, KV, D) keys and values, independent per (batch, head)
    -- on ``mesh`` through ``local_map`` (``core_specs``; ``rest_specs``
    place ``rest``), or as it is without a mesh.  A kernel wrapper
    reached from here gets each rank's local tensors, never a DTensor."""
    if mesh is None:
        return fn(q, k, v, *rest)
    qs, ks, ps = core_specs(mesh, q.shape[0], q.shape[2], k.shape[2],
                            bp_axes)
    return sh.local_call(fn, mesh, (qs, ks, ks) + tuple(
        ps if r == "pos" else r for r in rest_specs), qs, q, k, v, *rest)


def attention_fwd(params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, window: int = 0, causal: bool = True,
                  kv_x: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None,
                  kv=None, mesh=None) -> torch.Tensor:
    """Attention over a whole sequence, no cache.  x: (B, S, d_model);
    positions: (B, S), or (3, B, S) under M-RoPE.  ``window > 0`` keeps
    the keys of the last ``window`` positions (sliding window).  With
    ``kv_x`` (B, Sk, d_model) it is cross-attention: keys and values
    from ``kv_x``, no RoPE and no causal mask; ``kv`` is
    ``project_kv(params, kv_x, cfg)`` when the caller has it already.
    Under ``mesh`` the attention core runs per rank (``attention_core``),
    its batch over every mesh axis under ``cfg.attn_batch_parallel``."""
    h, d = cfg.num_heads, cfg.head_dim
    b, s, _ = x.shape
    src = kv_x if kv_x is not None else x
    sk = src.shape[1]
    q = sh.split_last(linear(x, params["wq"]), h, d)
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
    bp_axes = (_bp_spec(mesh, b)
               if (mesh is not None and cfg.attn_batch_parallel) else None)

    scale = d ** -0.5 if cfg.softmax_scale is None else cfg.softmax_scale

    def core(q, k, v, qp, kp):
        return blocked_attention(q, k, v, qp, kp,
                                 causal=causal and kv_x is None,
                                 window=window, scale=scale,
                                 cap=cfg.logit_softcap)

    out = attention_core(core, mesh, q, k, v, qp, kp, bp_axes=bp_axes,
                         rest_specs=("pos", "pos"))
    return linear(out.reshape(b, s, h * d), params["wo"])


def _seq_sharded(cache_t) -> bool:
    """A DTensor cache (B, S, KV, D) whose sequence dim a mesh axis
    shards (``cache_specs(seq_shard=True)``)."""
    return isinstance(cache_t, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in cache_t.placements)


def _decode_plain(q, ck, cv, index, slot, window: int, cap: float,
                  scale=None):
    """The reference's dense masked softmax of one query per head over
    the cache.  q: (B, KV, G, D) unscaled; ck, cv: (B, S, KV, D);
    ``scale``: the softmax scale, D^-1/2 when None."""
    d = q.shape[-1]
    s_cache = ck.shape[1]
    j = torch.arange(s_cache, device=q.device)
    if window > 0:
        # ring buffer: slot j holds position index - ((slot - j) mod S)
        valid = (slot - j) % s_cache <= index
    else:
        valid = j <= index
    qf = (q * (d ** -0.5 if scale is None else scale)).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, ck.float())
    if cap > 0:
        scores = softcap(scores, cap)
    scores = scores.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, cv.float())


def _decode_seq_sharded(q, ck, cv, index, mesh, cap: float, kernel: bool):
    """Decode over a cache whose sequence dim is sharded: each rank's
    partial softmax over its own rows, merged over the sharding axes
    with two all-reduces.  The valid slots of a cache of S slots are
    always the prefix ``j < min(index + 1, S)``: for a full cache the
    rows written so far, and for a ring buffer the reference's mask
    ``(slot - j) % S <= index`` of ``_decode_plain`` keeps slots
    ``0..index`` before the first wrap and every slot after it.  Each
    rank masks its global slots ``j = rank * n_local + arange(n_local)``
    by that prefix (plain route: the rank's max, sum and weighted values
    are merged), or calls the kernel on its own shard with the local
    lengths ``clamp(min(index + 1, S) - rank * n_local, 0, n_local)``
    and merges the ranks' outputs weighted by ``exp(lse - max lse)``.
    A rank with local length 0 scores every row -1e30 (the kernel's
    convention), so its weight underflows to exactly 0: rank 0 always
    holds slot 0, which is valid."""
    axes = tuple(axis_names(mesh)[m] for m, p in enumerate(ck.placements)
                 if isinstance(p, Shard) and p.dim == 1)
    d = q.shape[-1]
    s_cache = ck.shape[1]

    def body(q, ck, cv, index):
        n_local = ck.shape[1]
        start = sh.axis_index(mesh, axes) * n_local
        n_valid = torch.clamp(index + 1, max=s_cache)
        if kernel:
            lengths = torch.clamp(n_valid - start, 0, n_local).to(
                torch.int32).expand(q.shape[0]).contiguous()
            out, lse = decode_attention(q, ck, cv, lengths, return_lse=True)
            w = torch.exp(lse - sh.pmax(lse, mesh, axes))
            part = torch.cat([w[..., None], out.float() * w[..., None]],
                             dim=-1)
        else:
            j = start + torch.arange(n_local, device=q.device)
            qf = (q * (d ** -0.5)).float()
            scores = torch.einsum("bkgd,bskd->bkgs", qf, ck.float())
            if cap > 0:
                scores = softcap(scores, cap)
            scores = scores.masked_fill(
                ~(j < n_valid)[None, None, None, :], NEG_INF)
            m = sh.pmax(scores.amax(dim=-1), mesh, axes)
            p = torch.exp(scores - m[..., None])
            part = torch.cat([p.sum(-1)[..., None],
                              torch.einsum("bkgs,bskd->bkgd", p,
                                           cv.float())], dim=-1)
        part = sh.psum(part, mesh, axes)
        return part[..., 1:] / part[..., :1]

    dp = tuple(a for a in sh.FSDP if a in axis_names(mesh))
    cspec = (dp, axes, None, None)
    return sh.local_call(body, mesh, ((dp, None, None, None), cspec, cspec,
                                      ()), (dp, None, None, None),
                         q, ck, cv, index)


def decode_lengths(index, s_cache: int, b: int) -> torch.Tensor:
    """``decode_attention``'s valid rows of each of ``b`` sequences over a
    cache of ``s_cache`` slots at the 0-dim ``index``: ``min(index + 1,
    S)`` as (B,) int32, computed on the device."""
    return torch.clamp(index + 1, max=s_cache).to(torch.int32).expand(
        b).contiguous()


def decode_core(q, ck, cv, index, cfg: ModelConfig, *, window: int,
                mesh=None, lengths=None):
    """One query per head against the cache: ``(B, KV, G, D)`` f32 or
    the kernel's dtype.  The Hopper ``decode_attention`` kernel when
    ``cfg.use_pallas_decode`` and the guard hold (``lengths`` the valid
    rows of each sequence; ``None``: ``decode_lengths``), else the
    dense masked softmax.  Under ``mesh`` per rank through ``local_map``,
    the batch over the data axes and the KV heads over ``model`` where
    they divide it; a cache with its sequence dim sharded (full or a
    ring buffer) is attended per rank and merged across its ranks
    (``_decode_seq_sharded``, either route)."""
    b, kvh, g, d = q.shape
    s_cache = ck.shape[1]
    kernel = (cfg.use_pallas_decode and cfg.logit_softcap == 0
              and d % 8 == 0)
    if mesh is not None and _seq_sharded(ck):
        return _decode_seq_sharded(q, ck, cv, index, mesh,
                                   cfg.logit_softcap, kernel)
    if kernel:
        if lengths is None:
            lengths = decode_lengths(index, s_cache, b)
        extra = lengths

        def fn(q, ck, cv, lengths):
            return decode_attention(q, ck, cv, lengths.contiguous(),
                                    scale=cfg.softmax_scale)
    else:
        extra = index

        def fn(q, ck, cv, index):
            return _decode_plain(q, ck, cv, index, index % s_cache
                                 if window > 0 else index, window,
                                 cfg.logit_softcap, cfg.softmax_scale)
    if mesh is None:
        return fn(q, ck, cv, extra)
    dp = tuple(a for a in sh.FSDP if a in axis_names(mesh))
    n_model = axis_sizes(mesh).get("model", 1)
    heads = "model" if kvh % n_model == 0 else None
    qs, cs = (dp, heads, None, None), (dp, None, heads, None)
    return sh.local_call(fn, mesh, (qs, cs, cs, (dp,) if kernel else ()),
                         qs, q, ck, cv, extra)


def attention_decode(params, x: torch.Tensor, cache: dict, cache_index,
                     positions: torch.Tensor, cfg: ModelConfig, *,
                     window: int = 0, mesh=None, fused: bool = False,
                     lengths=None):
    """Single-token decode.  x: (B, 1, d_model); cache: {"k", "v"} of
    (B, S, KV, D), keys cached post-RoPE; ``cache_index`` (a 0-dim
    integer tensor, or an int) is the position of this token.  Writes
    the token's K/V into the cache in place and returns ``(y, cache)``.
    ``positions``: (B, 1), or (3, B, 1) under M-RoPE.  With ``window >
    0`` the cache is a ring buffer and the token goes to slot
    ``cache_index % S``.  Under ``fused`` (``transformer.fused_decode``)
    standard RoPE and the cache write are the ``rope_kv_write`` kernel,
    which reads the position from the index on the device, and the
    weight products are ``decode_linear``'s ``decode_gemm``.  ``lengths``:
    the kernel's valid rows, when the caller has them (``decode_core``).
    Under ``mesh`` the cache is a DTensor: each rank writes the rows of
    its own shard and the attention runs per rank (``decode_core``)."""
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = x.shape[0]
    q = sh.split_last(decode_linear(x, params["wq"], fused=fused), h, d)
    k = sh.split_last(decode_linear(x, params["wk"], fused=fused), kvh, d)
    v = sh.split_last(decode_linear(x, params["wv"], fused=fused), kvh, d)
    ck, cv = cache["k"], cache["v"]
    if fused and cfg.rope_kind == "standard":
        index = torch.as_tensor(cache_index, dtype=torch.int32,
                                device=x.device)
        q = rope_kv_write(q, k, v, index, ck, cv, cfg.rope_theta, window)
    else:
        q, k = _rope_qk(q, k, positions, cfg)
        index = torch.as_tensor(cache_index, device=x.device).long()
        slot = index % ck.shape[1] if window > 0 else index
        sh.write_rows(ck, 1, slot.view(1), k)
        sh.write_rows(cv, 1, slot.view(1), v)
        q = sh.fit_dim(q, 2, kvh).reshape(b, kvh, h // kvh, d)
    out = decode_core(q, ck, cv, index, cfg, window=window, mesh=mesh,
                      lengths=lengths)
    out = out.reshape(b, 1, h * d).to(x.dtype)
    return decode_linear(out, params["wo"], fused=fused), cache


def init_attention_cache(cfg: ModelConfig, batch: int, seq: int, dtype,
                         device, *, layers: int = 1, window: int = 0):
    """Zeroed K/V cache of ``layers`` stacked (B, S, KV, D) buffers, with
    S = ``min(seq, window)`` for a sliding window, else ``seq``."""
    s = min(seq, window) if window > 0 else seq
    shape = (layers, batch, s, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA -- DeepSeek multi-head latent attention
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype):
    dm, h = cfg.d_model, cfg.num_heads
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    vd = cfg.v_head_dim
    dev = gen.device
    return {
        "w_dq": dense_init(gen, (dm, cfg.q_lora_rank), dtype),
        "q_norm": torch.zeros(cfg.q_lora_rank, dtype=dtype, device=dev),
        "w_uq": dense_init(gen, (cfg.q_lora_rank, h * (nope + rope_d)), dtype),
        "w_dkv": dense_init(gen, (dm, cfg.kv_lora_rank + rope_d), dtype),
        "kv_norm": torch.zeros(cfg.kv_lora_rank, dtype=dtype, device=dev),
        "w_uk": dense_init(gen, (cfg.kv_lora_rank, h * nope), dtype),
        "w_uv": dense_init(gen, (cfg.kv_lora_rank, h * vd), dtype),
        "wo": dense_init(gen, (h * vd, dm), dtype, fan_in=h * vd),
    }


def _mla_qkv(params, x, positions, cfg: ModelConfig):
    """Shared projection logic. Returns q_nope, q_rope, c_kv, k_rope."""
    b, s, _ = x.shape
    h, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(linear(x, params["w_dq"]), params["q_norm"], cfg.norm_eps)
    q = sh.split_last(linear(cq, params["w_uq"]), h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = linear(x, params["w_dkv"])
    c_kv = rms_norm(ckv[..., :cfg.kv_lora_rank], params["kv_norm"],
                    cfg.norm_eps)
    k_rope = ckv[..., cfg.kv_lora_rank:][:, :, None, :]      # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_attend(params, q_nope, q_rope, c_kv, k_rope, positions,
               cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Causal attention over a whole sequence with per-head K/V
    materialised from the latent ``c_kv``, through the output
    projection."""
    b, s = q_nope.shape[:2]
    h, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vd = cfg.v_head_dim
    k_nope = sh.split_last(linear(c_kv, params["w_uk"]), h, nope)
    v = sh.split_last(linear(c_kv, params["w_uv"]), h, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], dim=-1)
    out = attention_core(
        lambda q, k, v, qp: blocked_attention(
            q, k, v, qp, qp, causal=True, window=0,
            scale=(nope + rope_d) ** -0.5),
        mesh, q, k, v, positions, rest_specs=("pos",))
    return linear(out.reshape(b, s, h * vd), params["wo"])


def mla_fwd(params, x: torch.Tensor, positions, cfg: ModelConfig,
            mesh=None) -> torch.Tensor:
    """Train/prefill MLA: materialize per-head K/V from the latent."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg)
    return mla_attend(params, q_nope, q_rope, c_kv, k_rope, positions, cfg,
                      mesh)


def mla_decode(params, x: torch.Tensor, cache: dict, cache_index, positions,
               cfg: ModelConfig):
    """Absorbed-matrix MLA decode: attend in the compressed latent space.

    cache: {"c_kv": (B, S, kv_lora), "k_rope": (B, S, rope_d)}; this
    token's latent and rope key go into slot ``cache_index`` in place.
    Returns ``(y, cache)``.
    """
    b = x.shape[0]
    h, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vd, r = cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg)
    c_kv_cache, k_rope_cache = cache["c_kv"], cache["k_rope"]
    index = torch.as_tensor(cache_index, device=x.device).long()
    sh.write_rows(c_kv_cache, 1, index.view(1), c_kv)
    sh.write_rows(k_rope_cache, 1, index.view(1), k_rope[:, :, 0])
    # absorb W_uk into q: q_eff (B,H,r)
    w_uk = params["w_uk"].reshape(r, h, nope)
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0].float(), w_uk.float())
    scale = (nope + rope_d) ** -0.5
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff, c_kv_cache.float()) * scale
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                          k_rope_cache.float()) * scale
    scores = s_lat + s_rope
    valid = torch.arange(scores.shape[-1], device=x.device) <= index
    scores = scores.masked_fill(~valid[None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, c_kv_cache.float())
    w_uv = params["w_uv"].reshape(r, h, vd)
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv.float())
    out = out.reshape(b, 1, h * vd).to(x.dtype)
    return linear(out, params["wo"]), cache


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int, dtype, device, *,
                   layers: int = 1):
    """Zeroed MLA cache of ``layers`` stacked latent and rope-key
    buffers."""
    return {"c_kv": torch.zeros((layers, batch, seq, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((layers, batch, seq, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}
