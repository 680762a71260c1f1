"""Public model API: ``build_model(cfg) -> Model`` with init, forward,
prefill, decode and the MTP head.

Counterpart of ``repro.models.api``: the dense stacks
(``attn+mlp`` or ``swa+mlp`` with standard RoPE and a SwiGLU or GeGLU
MLP), the MoE family (kimi-k2's ``attn+mlp`` then ``attn+moe`` groups
and deepseek-v3's ``mla+mlp`` then ``mla+moe``, standard RoPE, SwiGLU,
an MTP head of depth 1), Qwen2-VL's ``attn+mlp`` with M-RoPE, SwiGLU
and a prefix of patch embeddings, whisper's ``attn+mlp``
encoder-decoder with learned positions and a GELU MLP,
``rwkv6+rwkv_cm`` with no positions, or ``mamba2+none``, with or
without zamba2's shared attention block.  ``forward`` is the
reference's no-cache path over the whole sequence (with
``cfg.remat`` and grad enabled each layer is recomputed in the
backward, ``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` per layer) and returns the MoE layers' auxiliary
loss beside the logits; ``mtp_logits`` is DeepSeek-V3's
multi-token-prediction head, forward only.  A batch is the reference's dict: ``"tokens"`` (B, S),
and for Qwen2-VL ``"prefix_embeds"`` (B, P, d_model) before them with
``"mrope_positions"`` (3, B, P + S), for whisper ``"enc_embeds"`` (B,
encoder_seq_len, d_model); the frontends that make them are stubs in
the reference too.  Parameters are plain dicts of tensors: ``{"embed",
"final_norm", ["head",] ["pos_emb",] "layers": [per-layer dict, ...],
["shared_attn"], ["encoder": {"layers", "pos_emb", "final_norm"}],
["mtp": {"proj", "norm_h", "norm_e", "block"}]}`` -- the reference's
stacked groups ``params["groups"][g]`` (and
``params["encoder"]["groups"][0]``) with their leading layer axes
unstacked into one list in layer order (a Python loop over layers, each
of its own block kind ``cfg.blocks[i]``, takes the place of
``lax.scan`` per group).  An ``moe`` layer may hold a share of its
experts (``init_params(experts=...)``, ``models.moe``).  The
decode cache is the reference's ``cache["groups"]`` with the groups'
leading layer axes concatenated (every admitted stack has one mixer
kind over all its groups), plus ``"index"`` (a 0-dim int32 tensor on
the cache's device, as the reference's traced scalar): ``{"k", "v"}`` of shape (L, B, cache_len,
KV, D) for attention (for ``swa`` a ring buffer of ``min(cache_len,
window)`` slots), with whisper's ``"cross": {"k", "v"}`` of shape (L,
B, encoder_seq_len, KV, D), the encoder K/V each layer's
cross-attention reads; ``{"c_kv", "k_rope"}`` of shape (L, B,
cache_len, kv_lora_rank / qk_rope_dim) for MLA;
``{"tmix": {"shift", "wkv"}, "cmix": {"shift"}}``
for RWKV-6 (shifts (L, B, d) in the compute dtype, WKV state (L, B, H,
D, D) in f32); ``{"ssm": {"conv_x", "conv_bc", "h"}}`` for Mamba2 (conv
windows (L, B, W-1, C) in the compute dtype, SSD state (L, B, H, P, N)
in f32), with zamba2's ``"shared": {"k", "v"}`` of shape (apps, B,
min(cache_len, window), KV, D), one ring buffer per application of the
shared block (the reference's ``cache["shared"]``).  Prefill fills it
and decode updates it in place, the index included: no step reads a
device value back to the host, so a step can be captured as a CUDA
graph and replayed at every position.  A decode step of an M-RoPE
stack takes its (3, B, 1) ids as ``mrope_positions`` (a captured step
reads them from a static tensor), or, with None, the cache index for
all three, as the reference does.

Every entry point runs on ``cuda`` unless the caller names another
device; with no CUDA device and no explicit ``device="cpu"`` it raises.

Every step takes ``mesh`` (a ``DeviceMesh`` over ``("data", "model")``,
``"pod"`` too; ``build_model(cfg, mesh=...)`` passes it): the
parameters are then DTensors placed by ``sharding.param_specs``, the
batch and cache are placed by ``sharding.batch_specs`` /
``cache_specs``, and the step runs on DTensors (plain tensors it meets
taken as replicated), with the vocabulary-parallel lookup, the
attention cores, the scans, the cache writes and the expert-parallel
MoE per rank through ``local_map``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models import sharding as sh
from repro_torch.models import transformer as tfm
from repro_torch.models import zamba2 as z2
from repro_torch.models.common import (decode_linear, dense_init,
                                       embed_init, linear, rms_norm, to_dtype)

MAX_LEARNED_POS = 32768


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on an NVIDIA GPU "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "run its plain PyTorch path on the CPU")
    return dev


def _is_rwkv(cfg: ModelConfig) -> bool:
    return cfg.blocks[0] == "rwkv6+rwkv_cm"


def _is_mamba(cfg: ModelConfig) -> bool:
    return cfg.blocks[0] == "mamba2+none"


def _moe_shape_ok(cfg: ModelConfig) -> bool:
    """The MoE and MLA widths a grouped stack needs are set."""
    moe = (not cfg.uses_moe
           or (cfg.num_experts > 0 and cfg.moe_d_ff > 0
               and 0 < cfg.num_experts_per_tok <= cfg.num_experts))
    mla = ("mla" not in cfg.mixer_kinds
           or min(cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim,
                  cfg.qk_rope_dim, cfg.v_head_dim) > 0)
    return moe and mla


def _check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.blocks)
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    attention = cfg.rope_kind == "standard" and gated
    # the stacks without a prefix or an encoder
    decoder_only = not (cfg.is_encoder_decoder or cfg.num_patch_tokens)
    dense = (kinds in ({"attn+mlp"}, {"swa+mlp"}) and attention
             and not cfg.shared_attn_every and decoder_only)
    # the MoE family: dense then MoE groups over one attention mixer
    grouped = (kinds - {"attn+mlp"} == {"attn+moe"}
               or kinds <= {"mla+mlp", "mla+moe"}) and (
        cfg.rope_kind == "standard" and cfg.mlp_kind == "swiglu"
        and not cfg.shared_attn_every and decoder_only
        and _moe_shape_ok(cfg))
    vlm = (kinds == {"attn+mlp"} and cfg.rope_kind == "mrope" and gated
           and cfg.num_patch_tokens > 0 and not cfg.is_encoder_decoder
           and not cfg.shared_attn_every)
    audio = (kinds == {"attn+mlp"} and cfg.is_encoder_decoder
             and cfg.encoder_layers > 0 and cfg.rope_kind == "learned"
             and cfg.mlp_kind == "gelu" and not cfg.num_patch_tokens
             and not cfg.shared_attn_every)
    rwkv = (kinds == {"rwkv6+rwkv_cm"} and cfg.rope_kind == "none"
            and not cfg.shared_attn_every and decoder_only)
    mamba = (kinds == {"mamba2+none"} and decoder_only
             and (attention or not cfg.shared_attn_every)
             and not cfg.published_hybrid)
    # published Zamba2: the shared blocks' exact-GELU gated MLP
    zamba2 = (cfg.published_hybrid and kinds == {"mamba2+none"}
              and decoder_only and not cfg.shared_attn_every
              and cfg.rope_kind == "standard"
              and cfg.mlp_kind in ("swiglu", "geglu", "geglu_erf")
              and cfg.hybrid_layer_ids
              and all(0 <= i < cfg.num_layers for i in cfg.hybrid_layer_ids))
    mtp = cfg.mtp_depth == 0 or (cfg.mtp_depth == 1 and (dense or grouped))
    if (not (dense or grouped or vlm or audio or rwkv or mamba or zamba2)
            or cfg.logit_softcap or not mtp):
        raise NotImplementedError(
            f"{cfg.name}: only homogeneous stacks of dense attn+mlp or "
            "swa+mlp blocks (standard RoPE, SwiGLU or GeGLU), the MoE "
            "family (attn+mlp / attn+moe or mla+mlp / mla+moe groups, "
            "standard RoPE, SwiGLU; an MTP head of depth 1 on these and "
            "the dense stacks), Qwen2-VL's attn+mlp (M-RoPE, SwiGLU, "
            "patch prefix), whisper's attn+mlp encoder-decoder (learned "
            "positions, GELU), rwkv6+rwkv_cm blocks (no RoPE) or "
            "mamba2+none blocks (a shared attention block with standard "
            "RoPE and SwiGLU or GeGLU, or published Zamba2's shared "
            "blocks) are ported yet")


@functools.lru_cache(maxsize=None)
def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The configuration whisper's encoder layers run under: no
    cross-attention, no RoPE."""
    return dataclasses.replace(cfg, is_encoder_decoder=False,
                               rope_kind="none", shared_attn_every=0)


def _shared_apps(cfg: ModelConfig) -> int:
    """Applications of the shared attention block (one before every
    ``shared_attn_every``-th layer)."""
    every = cfg.shared_attn_every
    return (cfg.num_layers + every - 1) // every


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig,
                experts: Optional[Tuple[int, int]] = None):
    """Random parameters drawn from ``gen`` on its device, each leaf in
    the reference's dtype: ``cfg.param_dtype`` except the leaves the
    reference keeps in f32 (RWKV-6's decay base, bonus and group-norm
    affine, the MoE router).  Every ``moe`` block (the MTP head's too)
    holds the experts ``experts = (e_lo, e_local)`` of its router's
    ``cfg.num_experts`` (all when None), and the shared expert when they
    start at expert 0: one rank's share of expert parallelism
    (``models.moe``)."""
    dtype = to_dtype(cfg.param_dtype)
    dev = gen.device
    p = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
         "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype)
    if cfg.rope_kind == "learned":
        p["pos_emb"] = embed_init(gen, (MAX_LEARNED_POS, cfg.d_model), dtype)
    p["layers"] = [tfm.init_block(gen, cfg, kind, dtype, dev, experts)
                   for kind in cfg.blocks]
    if cfg.shared_attn_every:
        p["shared_attn"] = tfm.init_shared_attn(gen, cfg, dtype, dev)
    if cfg.published_hybrid:
        z2.init_extra(gen, cfg, p, dtype, dev)
    if cfg.is_encoder_decoder:
        ecfg = _encoder_cfg(cfg)
        p["encoder"] = {
            "layers": [tfm.init_block(gen, ecfg, "attn+mlp", dtype, dev)
                       for _ in range(cfg.encoder_layers)],
            "pos_emb": embed_init(gen, (cfg.encoder_seq_len, cfg.d_model),
                                  dtype),
            "final_norm": torch.zeros(cfg.d_model, dtype=dtype, device=dev)}
    if cfg.mtp_depth:
        p["mtp"] = {
            "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), dtype),
            "norm_h": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
            "norm_e": torch.zeros(cfg.d_model, dtype=dtype, device=dev),
            "block": tfm.init_block(gen, cfg, cfg.blocks[-1], dtype, dev,
                                    experts)}
    return p


def params_from_jax(tree, cfg: ModelConfig, device=None):
    """The reference's ``Model.init`` pytree, already converted to numpy
    arrays by the caller, as this package's parameters on ``device``.
    The leading layer axis of each group of ``tree["groups"]`` is
    unstacked into ``params["layers"]``, group after group, and that of
    whisper's
    ``tree["encoder"]["groups"][0]`` into ``params["encoder"]["layers"]``
    (the encoder's own stack, not a second decoder group);
    ``tree["shared_attn"]`` (one weight set, no layer axis) is taken as
    it is, and so is the MTP head ``tree["mtp"]``; every weight keeps
    its (in, out) layout.  A leaf that is f32 in the tree stays f32 (the reference
    keeps some in f32 at every param dtype); the others go to
    ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dtype = to_dtype(cfg.param_dtype)

    def conv(a):
        a = np.asarray(a)
        target = torch.float32 if a.dtype == np.float32 else dtype
        # bf16 numpy arrays (ml_dtypes) widen to f32 exactly first; the
        # copy also makes arrays that came from JAX (read-only) writable
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a, copy=True)).to(dev, target)

    groups = tree["groups"]
    spec = tfm.layer_groups(cfg)
    if len(groups) != len(spec):
        raise ValueError(f"{cfg.name}: {len(groups)} stacked groups for "
                         f"the config's {len(spec)}")

    def each(tr, fn):
        return {k: each(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tr.items()}

    p = {"embed": conv(tree["embed"]), "final_norm": conv(tree["final_norm"]),
         "layers": [each(stacked, lambda a, i=i: conv(a[i]))
                    for (_, n), stacked in zip(spec, groups)
                    for i in range(n)]}
    if not cfg.tie_embeddings:
        p["head"] = conv(tree["head"])
    if cfg.rope_kind == "learned":
        p["pos_emb"] = conv(tree["pos_emb"])
    if cfg.shared_attn_every:
        p["shared_attn"] = each(tree["shared_attn"], conv)
    if cfg.mtp_depth:
        p["mtp"] = each(tree["mtp"], conv)
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        (stacked,) = enc["groups"]
        p["encoder"] = {
            "layers": [each(stacked, lambda a, i=i: conv(a[i]))
                       for i in range(cfg.encoder_layers)],
            "pos_emb": conv(enc["pos_emb"]),
            "final_norm": conv(enc["final_norm"])}
    return p


# ---------------------------------------------------------------------------
# embedding / head / cache
# ---------------------------------------------------------------------------

def _lookup(table, tokens, mesh=None):
    """The rows ``tokens`` of ``table`` (``embedding``).  Under ``mesh``
    with a DTensor table, per rank (Megatron's vocabulary-parallel
    lookup): each rank looks up the ids of its own vocabulary rows, the
    others' rows as zeros, and the ranks that shard the vocabulary sum
    their rows (exactly one is not zero).  The batch of ids stays over
    the data axes; the table is whole along d on each rank."""
    # ``embedding`` on both routes (the rows indexing gives), so that a
    # step on a mesh takes the unsharded step's backward
    if mesh is None or not sh.is_dtensor(table):
        return torch.nn.functional.embedding(tokens, table)
    names = sh.axis_names(mesh)
    vocab = tuple(names[m] for m, p in enumerate(table.placements)
                  if p.is_shard(0))

    def body(tab, tok):
        rows = tab.shape[0]
        rel = tok - sh.axis_index(mesh, vocab) * rows
        inside = (rel >= 0) & (rel < rows)
        x = torch.nn.functional.embedding(torch.where(inside, rel, 0), tab)
        return sh.psum(x * inside[..., None].to(x.dtype), mesh, vocab)

    dp = sh.dp_axes(mesh)
    tok_spec = (dp,) + (None,) * (tokens.ndim - 1)
    return sh.local_call(body, mesh, ((vocab or None, None), tok_spec),
                         tok_spec + (None,), table, tokens)


def _embed(params, cfg: ModelConfig, tokens, positions=None, mesh=None):
    x = _lookup(params["embed"], tokens, mesh)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.rope_kind == "learned" and positions is not None:
        x = x + params["pos_emb"][positions]
    return x


def _head(params, cfg: ModelConfig, x, fused: bool = False):
    """The logits; under ``fused`` (a decode step on
    ``transformer.fused_decode``'s route) ``decode_linear``'s
    ``decode_gemm``, which reads a tied embedding in place."""
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return decode_linear(x, w, fused=fused)


def _dp_axes(mesh) -> tuple:
    if mesh is None:
        return ("data",)
    return sh.dp_axes(mesh)


def _constrain(x, mesh, spec):
    """The reference's ``with_sharding_constraint``: ``x`` redistributed
    to ``spec`` on ``mesh`` (nothing without a mesh)."""
    return sh.constrain(x, mesh, spec)


_mesh_scope = sh.mesh_scope


def _on_mesh(batch: dict, mesh) -> dict:
    """The batch's tensors placed by ``sharding.batch_specs`` (a DTensor
    stays as it is)."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and not sh.is_dtensor(v):
            spec = sh.batch_specs({k: v}, mesh)[k]
            v = sh.constrain(v, mesh, spec)
        out[k] = v
    return out


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
               mesh=None, seq_shard: bool = False):
    """A zero decode cache; an RWKV-6 or Mamba2 state does not depend on
    ``cache_len`` (the shared block's ring buffers do).  An ``swa``
    stack's K/V hold ``min(cache_len, window)`` slots, whisper's cross
    K/V ``encoder_seq_len`` rows, an MLA stack's latent and rope keys
    ``cache_len``.  Under ``mesh`` every leaf is a DTensor placed by
    ``sharding.cache_specs`` (``seq_shard``: the sequence dim over
    ``model``), the index replicated."""
    if mesh is not None:
        cache = init_cache(cfg, batch, cache_len, device)
        return sh.distribute(cache, sh.cache_specs(cache, mesh, seq_shard),
                             mesh)
    dtype = to_dtype(cfg.dtype)
    if _is_rwkv(cfg):
        cache = rk.init_rwkv6_state(cfg, batch, dtype, device,
                                    layers=cfg.num_layers)
    elif _is_mamba(cfg):
        cache = {"ssm": m2.init_mamba2_state(cfg, batch, dtype, device,
                                             layers=cfg.num_layers)}
    elif "mla" in cfg.mixer_kinds:
        cache = attn_mod.init_mla_cache(cfg, batch, cache_len, dtype, device,
                                        layers=cfg.num_layers)
    else:
        window = cfg.window_size if "swa" in cfg.mixer_kinds else 0
        cache = attn_mod.init_attention_cache(cfg, batch, cache_len, dtype,
                                              device, layers=cfg.num_layers,
                                              window=window)
    if cfg.shared_attn_every:
        cache["shared"] = attn_mod.init_attention_cache(
            cfg, batch, cache_len, dtype, device, layers=_shared_apps(cfg),
            window=cfg.shared_attn_window or cache_len)
    if cfg.published_hybrid:
        cache["shared"] = attn_mod.init_attention_cache(
            cfg, batch, cache_len, dtype, device,
            layers=len(cfg.hybrid_layer_ids))
    if cfg.is_encoder_decoder:
        cache["cross"] = attn_mod.init_attention_cache(
            cfg, batch, cfg.encoder_seq_len, dtype, device,
            layers=cfg.num_layers)
    cache["index"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def _zero_cache(cache: dict) -> None:
    """Every tensor of ``cache`` set to zero in place: the fresh state
    ``init_cache`` gives, in the same storage."""
    for v in cache.values():
        if isinstance(v, dict):
            _zero_cache(v)
        else:
            v.zero_()


def _layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s views into the decode cache (no copy), without the
    shared block's ring buffers."""
    return {k: _layer_cache(v, i) if isinstance(v, dict) else v[i]
            for k, v in cache.items() if k not in ("index", "shared")}


def _shared_cache(cache: dict, app: int) -> dict:
    """Application ``app``'s views into the shared block's ring buffers."""
    return {k: v[app] for k, v in cache["shared"].items()}


# ---------------------------------------------------------------------------
# forward (no cache)
# ---------------------------------------------------------------------------

def _positions_for(cfg: ModelConfig, batch: dict, b: int, s: int, device):
    """The sequence's positions: the batch's (3, B, S) ids under M-RoPE,
    None for a stack without positions, else (B, S) 0..S-1."""
    if cfg.rope_kind == "mrope":
        return batch["mrope_positions"].to(device).long()
    if _is_rwkv(cfg):
        return None
    return torch.arange(s, device=device).expand(b, s)


def _run_layer(layer, x, cfg: ModelConfig):
    """``layer(x)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    is set and grad is enabled: its activations are recomputed in the
    backward instead of kept (the reference's ``jax.checkpoint`` of each
    layer's body)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(layer, x, use_reentrant=False)
    return layer(x)


def _encoder_fwd(params, cfg: ModelConfig, enc_embeds, mesh=None):
    """Whisper's encoder: learned positions, bidirectional attention,
    the final norm."""
    enc = params["encoder"]
    b, s, _ = enc_embeds.shape
    x = enc_embeds + enc["pos_emb"][None, :s]
    positions = torch.arange(s, device=x.device).expand(b, s)
    ecfg = _encoder_cfg(cfg)
    for p in enc["layers"]:
        x, _ = _run_layer(functools.partial(
            tfm.block_fwd, p, positions=positions, kind="attn+mlp",
            cfg=ecfg, causal=False, mesh=mesh), x, cfg)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _assemble_inputs(params, cfg: ModelConfig, batch: dict, mesh=None):
    """The decoder's input embeddings, positions and encoder output:
    ``(x (B, S_total, d_model), positions, enc_out, S_total)``, S_total
    counting the prefix of patch embeddings."""
    batch = _on_mesh(batch, mesh)
    tokens = batch["tokens"].long()
    b, dev = tokens.shape[0], tokens.device
    dtype = to_dtype(cfg.dtype)
    prefix = (batch["prefix_embeds"]
              if cfg.num_patch_tokens and "prefix_embeds" in batch else None)
    s_total = tokens.shape[1] + (0 if prefix is None else prefix.shape[1])
    positions = _positions_for(cfg, batch, b, s_total, dev)
    tok_positions = positions if cfg.rope_kind != "mrope" else None
    if prefix is not None:
        pe = prefix.to(dev, dtype)
        te = _embed(params, cfg, tokens,
                    None if tok_positions is None else
                    tok_positions[:, pe.shape[1]:], mesh)
        x = torch.cat([pe, te], dim=1)
    else:
        x = _embed(params, cfg, tokens, tok_positions, mesh)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encoder_fwd(params, cfg,
                               batch["enc_embeds"].to(dev, dtype), mesh)
    x = _constrain(x, mesh, (sh.FSDP, None, None))
    return x, positions, enc_out, s_total


def forward_hidden(params, batch: dict, cfg: ModelConfig, mesh=None):
    """Like ``forward`` but returns the hidden states before the final
    norm, ``(x (B, S, d_model), aux)`` (the input of ``mtp_logits``)."""
    with _mesh_scope(mesh):
        x, positions, enc_out, _ = _assemble_inputs(params, cfg, batch, mesh)
        shared, every = params.get("shared_attn"), cfg.shared_attn_every
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.published_hybrid:
            return z2.forward_layers(
                params, x, positions, cfg,
                lambda fn, x: _run_layer(fn, x, cfg)), aux
        for i, p in enumerate(params["layers"]):
            def layer(x, p=p, i=i):
                if shared is not None and i % every == 0:
                    x = tfm.shared_attn_fwd(shared, x, positions, cfg, mesh)
                return tfm.block_fwd(p, x, positions, cfg.blocks[i], cfg,
                                     enc_out=enc_out, mesh=mesh)
            x, a = _run_layer(layer, x, cfg)
            aux = aux + a
        return x, aux


def forward(params, batch: dict, cfg: ModelConfig, mesh=None):
    """Full-sequence forward with no cache.  ``batch["tokens"]``: (B, S)
    integer ids (and the prefix or encoder inputs of the stack).  Returns
    ``(logits (B, S_total, V), aux)``; ``aux`` is the reference's
    auxiliary loss, 0 without MoE layers.  Under ``mesh`` (a
    ``DeviceMesh``; the parameters DTensors placed by
    ``sharding.param_specs``) the batch is placed by
    ``sharding.batch_specs`` and the logits come back as a DTensor, the
    batch over the data axes and the vocabulary over ``model``."""
    with _mesh_scope(mesh):
        x, aux = forward_hidden(params, batch, cfg, mesh)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = _constrain(_head(params, cfg, x), mesh,
                            (sh.FSDP, None, "model"))
    return logits, aux


def mtp_logits(params, hidden, tokens, cfg: ModelConfig, mesh=None):
    """DeepSeek-V3 multi-token prediction head (depth 1): from hidden state
    h_t and the embedding of token t+1, predict token t+2.  ``hidden``:
    (B, S, d_model) from ``forward_hidden``; ``tokens``: (B, S).  Returns
    ``(logits (B, S - 1, V), aux)``."""
    with _mesh_scope(mesh):
        p = params["mtp"]
        if mesh is not None and not sh.is_dtensor(tokens):
            tokens = sh.constrain(tokens, mesh, (sh.FSDP, None))
        h = rms_norm(hidden[:, :-1], p["norm_h"], cfg.norm_eps)
        e = rms_norm(_embed(params, cfg, tokens[:, 1:].long(), mesh=mesh),
                     p["norm_e"], cfg.norm_eps)
        z = linear(torch.cat([h, e], dim=-1), p["proj"])
        b, s, _ = z.shape
        positions = torch.arange(s, device=z.device).expand(b, s)
        z, aux = tfm.block_fwd(p["block"], z, positions, cfg.blocks[-1], cfg,
                               mesh=mesh)
        z = rms_norm(z, params["final_norm"], cfg.norm_eps)
        return _constrain(_head(params, cfg, z), mesh,
                          (sh.FSDP, None, "model")), aux


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def prefill(params, batch: dict, cfg: ModelConfig,
            cache_len: Optional[int] = None, cache: Optional[dict] = None,
            mesh=None):
    """Process the whole prompt; returns ``(last_logits (B, V), cache)``.
    ``batch["tokens"]``: (B, S) integer token ids on the model's device
    (and the prefix or encoder inputs of the stack; S_total counts the
    prefix).  With ``cache`` (an ``init_cache`` of batch B, e.g. a
    captured step's static cache) the prompt fills that cache, zeroed
    first, so that it starts from the fresh state a new cache has;
    ``cache_len`` is then the given cache's.  Under ``mesh`` a new cache
    is placed by ``sharding.cache_specs`` and every write lands on the
    rank that holds the row."""
    with _mesh_scope(mesh):
        x, positions, enc_out, s = _assemble_inputs(params, cfg, batch, mesh)
        b = x.shape[0]
        if cache is None:
            cache = init_cache(cfg, b, cache_len or s, x.device, mesh)
        else:
            _zero_cache(cache)
        shared, every = params.get("shared_attn"), cfg.shared_attn_every
        if cfg.published_hybrid:
            x = z2.prefill_layers(params, x, positions, cfg,
                                  lambda i: _layer_cache(cache, i),
                                  lambda j: _shared_cache(cache, j))
        else:
            for i, p in enumerate(params["layers"]):
                if shared is not None and i % every == 0:
                    x = tfm.shared_attn_prefill(
                        shared, x, positions, cfg,
                        _shared_cache(cache, i // every), mesh)
                x = tfm.block_prefill(p, x, positions, cfg.blocks[i], cfg,
                                      _layer_cache(cache, i),
                                      enc_out=enc_out, mesh=mesh)
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
        logits = _head(params, cfg, x)
        cache["index"].fill_(s)
    return logits[:, 0], cache


def _decode_lengths(cfg: ModelConfig, cache: dict, index, b: int,
                    mesh) -> dict:
    """``decode_attention``'s valid rows of the step, once a step and not
    once a layer: under ``"k"`` for the layers' K/V cache, under
    ``"shared"`` for the shared block's ring buffers, each where the
    cache has it; empty off the kernel route or under a mesh (there
    ``attention.decode_core`` computes them per rank)."""
    if not cfg.use_pallas_decode or mesh is not None:
        return {}
    return {name: attn_mod.decode_lengths(index, kv["k"].shape[2], b)
            for name, kv in (("k", cache), ("shared", cache.get("shared")))
            if kv is not None and "k" in kv}


def decode_step(params, cache: dict, token, cfg: ModelConfig,
                mrope_positions=None, mesh=None):
    """One serve step: one new token per sequence against the cache.

    token: (B, 1) integer ids; ``mrope_positions``: (3, B, 1) ids of an
    M-RoPE stack, or None for the cache index in all three (the
    reference's default).  Returns ``(logits (B, V), cache)``:
    this step updates the cache's tensors (K/V, recurrent state or ring
    buffers, the index) in place, and the index is one further after it.
    Positions, ring slots and attention lengths come from the index on
    the device.  Each block hands its output to the next block's first
    norm, which adds it to the residual (``transformer.block_decode``);
    bf16 on the card takes the fused kernels
    (``transformer.fused_decode``).  Under ``mesh`` the cache is
    ``init_cache(mesh=)``'s or ``prefill``'s DTensors."""
    with _mesh_scope(mesh):
        index = cache["index"]
        if mesh is not None and not sh.is_dtensor(token):
            token = sh.constrain(token, mesh, (sh.FSDP, None))
        token = token.long()
        b = token.shape[0]
        if cfg.rope_kind == "mrope":
            positions = (index.long().expand(3, b, 1)
                         if mrope_positions is None
                         else mrope_positions.long())
        elif _is_rwkv(cfg):
            positions = None
        else:
            positions = index.long().expand(b, 1)
        x = _embed(params, cfg, token,
                   positions if cfg.rope_kind != "mrope" else None, mesh)
        fused = tfm.fused_decode(cfg, x, mesh)
        lengths = _decode_lengths(cfg, cache, index, b, mesh)
        shared, every = params.get("shared_attn"), cfg.shared_attn_every
        y = None
        if cfg.published_hybrid:
            x, y = z2.decode_layers(params, x, index, positions, cfg,
                                    lambda i: _layer_cache(cache, i),
                                    lambda j: _shared_cache(cache, j), fused,
                                    lengths.get("shared"))
        else:
            for i, p in enumerate(params["layers"]):
                if shared is not None and i % every == 0:
                    x, y = tfm.shared_attn_decode(
                        shared, x, _shared_cache(cache, i // every), index,
                        positions, cfg, mesh, y, fused, lengths.get("shared"))
                x, y = tfm.block_decode(p, x, _layer_cache(cache, i), index,
                                        positions, cfg.blocks[i], cfg, mesh,
                                        y, fused, lengths.get("k"))
        _, x = tfm.add_norm(x, y, params["final_norm"], cfg, fused)
        logits = _head(params, cfg, x, fused)
        index.add_(1)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Model namespace
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    mesh: Any = None

    def init(self, gen: torch.Generator,
             experts: Optional[Tuple[int, int]] = None):
        return init_params(gen, self.cfg, experts)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on the model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def forward(self, params, batch):
        return forward(params, batch, self.cfg, self.mesh)

    def forward_hidden(self, params, batch):
        return forward_hidden(params, batch, self.cfg, self.mesh)

    def mtp_logits(self, params, hidden, tokens):
        return mtp_logits(params, hidden, tokens, self.cfg, self.mesh)

    def prefill(self, params, batch, cache_len=None, cache=None):
        return prefill(params, batch, self.cfg, cache_len, cache, self.mesh)

    def decode_step(self, params, cache, token, mrope_positions=None):
        return decode_step(params, cache, token, self.cfg, mrope_positions,
                           self.mesh)

    def init_cache(self, batch: int, cache_len: int):
        return init_cache(self.cfg, batch, cache_len, self.device, self.mesh)


def build_model(cfg: ModelConfig, mesh=None, device=None) -> Model:
    """The model namespace of ``cfg``.  With ``mesh`` (a ``DeviceMesh``)
    its steps run sharded over it, on the mesh's device type unless
    ``device`` names one; a ``cuda`` mesh never runs on the CPU
    (published Zamba2 runs on one device only)."""
    _check_supported(cfg)
    if mesh is not None and cfg.published_hybrid:
        raise NotImplementedError(f"{cfg.name}: published Zamba2 runs "
                                  "without a mesh")
    if device is None and mesh is not None:
        device = mesh.device_type
    return Model(cfg=cfg, device=resolve_device(device), mesh=mesh)


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict:
    """Stand-ins for every model input of a given shape: ``meta``
    tensors (shape and dtype, no storage), the counterpart of the
    reference's ``ShapeDtypeStruct``s.

    The modality frontends are stubs per the assignment carve-out: audio
    supplies (B, encoder_seq_len, d) frame embeddings, VLM supplies
    (B, num_patch_tokens, d) patch embeddings.
    """
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    f32 = to_dtype(cfg.dtype)
    i32 = torch.int32

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        s_text = s
        if cfg.num_patch_tokens:
            s_text = s - cfg.num_patch_tokens
            specs["prefix_embeds"] = sds((b, cfg.num_patch_tokens,
                                          cfg.d_model), f32)
            specs["mrope_positions"] = sds((3, b, s), i32)
        specs["tokens"] = sds((b, s_text), i32)
        if shape.kind == "train":
            specs["labels"] = sds((b, s_text), i32)
        if cfg.is_encoder_decoder:
            specs["enc_embeds"] = sds((b, cfg.encoder_seq_len, cfg.d_model),
                                      f32)
    else:  # decode
        specs["token"] = sds((b, 1), i32)
        if cfg.rope_kind == "mrope":
            specs["mrope_positions"] = sds((3, b, 1), i32)
    return specs
