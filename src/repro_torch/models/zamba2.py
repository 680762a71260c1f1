"""Published Zamba2 (``Zamba2Config``, zamba2-7b): the shared blocks,
their per-application adapters and linears, and the hybrid layers, for
the no-cache forward, the prefill and the decode step.

Zyphra's ``Zamba2ForCausalLM`` (arXiv:2411.15242), as this package
serves it.  Every layer is ``mamba2+none``: ``x <- x + Mamba2(RMSNorm(x))``
(``transformer.block_*``).  At the hybrid layer of application j
(``cfg.hybrid_layer_ids[j]``) the shared block ``S = shared_blocks[j %
num_mem_blocks]`` reads the residual and the token embedding e0 and,
with no residual inside::

    h = RMSNorm_2d(cat(x, e0));  a = Attn(h)   (2 d -> H x D -> d)
    t = L_j(MLP_j(RMSNorm_d(a)))

``Attn`` is causal attention with RoPE and the configuration's softmax
scale; ``MLP_j`` is the exact-GELU gated MLP whose gate and up products
add application j's adapter, ``[g | u] = W_gu h + B_j(A_j h)``; ``L_j``
is the layer's own d x d linear.  Only the Mamba2 input takes t: ``x <-
x + Mamba2(RMSNorm(x + t))``.

Parameters: every layer's ``{"norm1", "mamba"}``, a hybrid layer's also
``"hybrid": {"adapter_a" (d, r), "adapter_b" (r, 2 d_ff) [gate | up],
"w_out" (d, d)}``, and ``params["shared_blocks"]``, one ``{"norm1"
(2 d), "attn": {"wq", "wk", "wv" (2 d, H D), "wo" (H D, d)}, "norm2"
(d), "mlp": {"w_gate", "w_up", "w_down"}}`` per block.  The decode
cache holds every layer's Mamba2 state and, under ``"shared"``, one
full-length K/V cache per application (no window).

The prefill runs attention on ``swa_prefill`` (window = prompt) and the
SSD on ``ssd_scan`` under ``cfg.use_pallas_prefill``; a decode step
``decode_attention`` and the T = 1 ``ssd_scan`` under
``cfg.use_pallas_decode``, and in bf16 on the card the fused
``add_rms_norm``, ``rope_kv_write`` and ``glu_gate`` kernels, each
Mamba2 layer's ``mamba2_conv_step`` and ``mamba2_gate_norm``, and every
weight product of the step on ``decode_gemm``
(``transformer.fused_decode``).  No mesh: a mesh is refused.

The shared-block applications run are counted as ``shared_applications``
in ``utils/counters.py``'s table (``serving/capture.py`` adds a captured
step's on each replay).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.glu_gate.ops import glu_gate, glu_gate_plain
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (decode_linear, dense_init, linear,
                                       rms_norm)
from repro_torch.models.mlp import init_mlp
from repro_torch.utils import counters

counters.bump("shared_applications", 0)


def applications(cfg: ModelConfig) -> dict:
    """Layer index -> application index of every hybrid layer."""
    return {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}


def init_shared_block(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    d, inner = cfg.d_model, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    return {"norm1": torch.zeros(2 * d, dtype=dtype, device=device),
            "attn": {"wq": dense_init(gen, (2 * d, inner), dtype),
                     "wk": dense_init(gen, (2 * d, kv), dtype),
                     "wv": dense_init(gen, (2 * d, kv), dtype),
                     "wo": dense_init(gen, (inner, d), dtype, fan_in=inner)},
            "norm2": torch.zeros(d, dtype=dtype, device=device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype)}


def init_hybrid(gen: torch.Generator, cfg: ModelConfig, dtype):
    """Application j's own weights: the adapter and ``L_j``."""
    d, r = cfg.d_model, cfg.adapter_rank
    return {"adapter_a": dense_init(gen, (d, r), dtype),
            "adapter_b": dense_init(gen, (r, 2 * cfg.d_ff), dtype),
            "w_out": dense_init(gen, (d, d), dtype)}


def init_extra(gen: torch.Generator, cfg: ModelConfig, params: dict, dtype,
               device) -> None:
    """Add the hybrid layers' weights and the shared blocks to
    ``params`` (whose layers are drawn already)."""
    for i in cfg.hybrid_layer_ids:
        params["layers"][i]["hybrid"] = init_hybrid(gen, cfg, dtype)
    params["shared_blocks"] = [init_shared_block(gen, cfg, dtype, device)
                               for _ in range(cfg.num_mem_blocks)]


def _mlp(p, hyb, h, cfg: ModelConfig, fused: bool = False):
    """``down(act(g) * u)``, ``[g | u] = W_gu h + B_j(A_j h)``; under
    ``fused`` each product is ``decode_linear``'s ``decode_gemm``."""
    def mm(x, w):
        return decode_linear(x, w, fused=fused)
    ab = mm(mm(h, hyb["adapter_a"]), hyb["adapter_b"])
    f = cfg.d_ff
    gate = mm(h, p["w_gate"]) + ab[..., :f]
    up = mm(h, p["w_up"]) + ab[..., f:]
    act = (glu_gate if fused else glu_gate_plain)(gate.contiguous(),
                                                  up.contiguous(),
                                                  cfg.mlp_kind)
    return mm(act, p["w_down"])


def _block_of(params, cfg: ModelConfig, j: int):
    counters.bump("shared_applications")
    return params["shared_blocks"][j % cfg.num_mem_blocks]


def shared_fwd(params, hyb, j: int, x, e0, positions, cfg: ModelConfig):
    """Application j over the whole sequence, no cache: ``t``."""
    p = _block_of(params, cfg, j)
    h = rms_norm(torch.cat([x, e0], dim=-1), p["norm1"], cfg.norm_eps)
    a = attn.attention_fwd(p["attn"], h, positions, cfg, window=0)
    h = rms_norm(a, p["norm2"], cfg.norm_eps)
    return linear(_mlp(p["mlp"], hyb, h, cfg), hyb["w_out"])


def shared_prefill(params, hyb, j: int, x, e0, positions, cfg: ModelConfig,
                   cache: dict):
    """Application j over the prompt, filling its K/V ``cache``: ``t``."""
    p = _block_of(params, cfg, j)
    h = rms_norm(torch.cat([x, e0], dim=-1), p["norm1"], cfg.norm_eps)
    a = tfm._attn_prefill(p["attn"], h, positions, cfg, 0, cache)
    h = rms_norm(a, p["norm2"], cfg.norm_eps)
    return linear(_mlp(p["mlp"], hyb, h, cfg), hyb["w_out"])


def shared_decode(params, hyb, j: int, x, e0, cache: dict, index, positions,
                  cfg: ModelConfig, fused: bool, lengths=None):
    """Application j at one decode token over its K/V ``cache``: ``t``."""
    p = _block_of(params, cfg, j)
    _, h = tfm.add_norm(torch.cat([x, e0], dim=-1), None, p["norm1"], cfg,
                        fused)
    a, _ = attn.attention_decode(p["attn"], h, cache, index, positions, cfg,
                                 window=0, fused=fused, lengths=lengths)
    _, h = tfm.add_norm(a, None, p["norm2"], cfg, fused)
    return decode_linear(_mlp(p["mlp"], hyb, h, cfg, fused), hyb["w_out"],
                         fused=fused)


def forward_layers(params, x, positions, cfg: ModelConfig, run_layer):
    """Every layer over the whole sequence, no cache; ``x`` the token
    embedding.  ``run_layer(fn, x)`` runs one layer (``api._run_layer``:
    under grad with ``cfg.remat``, recomputed in the backward)."""
    e0, apps = x, applications(cfg)
    for i, p in enumerate(params["layers"]):
        def layer(x, p=p, i=i):
            if i not in apps:
                return tfm.block_fwd(p, x, positions, cfg.blocks[i], cfg)[0]
            t = shared_fwd(params, p["hybrid"], apps[i], x, e0, positions,
                           cfg)
            h = rms_norm(x + t, p["norm1"], cfg.norm_eps)
            y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None, train_form=True)
            return x + y
        x = run_layer(layer, x)
    return x


def prefill_layers(params, x, positions, cfg: ModelConfig, layer_cache,
                   shared_cache):
    """Every layer over the prompt, filling the cache; ``x`` the token
    embedding.  ``layer_cache(i)`` / ``shared_cache(j)``: the views of
    layer i's state and of application j's K/V."""
    e0, apps = x, applications(cfg)
    for i, p in enumerate(params["layers"]):
        if i not in apps:
            x = tfm.block_prefill(p, x, positions, cfg.blocks[i], cfg,
                                  layer_cache(i))
            continue
        j = apps[i]
        t = shared_prefill(params, p["hybrid"], j, x, e0, positions, cfg,
                           shared_cache(j))
        h = rms_norm(x + t, p["norm1"], cfg.norm_eps)
        y, _ = m2.mamba2_fwd(p["mamba"], h, cfg, None,
                             kernel=cfg.use_pallas_prefill,
                             out=layer_cache(i)["ssm"])
        x = x + y
    return x


def decode_layers(params, x, index, positions, cfg: ModelConfig,
                  layer_cache, shared_cache, fused: bool, lengths=None):
    """Every layer at one decode token; ``x`` the token's embedding.
    Returns ``(x, y)``: the residual and the last layer's output not yet
    added (``transformer.block_decode``)."""
    e0, apps, y = x, applications(cfg), None
    for i, p in enumerate(params["layers"]):
        if i not in apps:
            x, y = tfm.block_decode(p, x, layer_cache(i), index, positions,
                                    cfg.blocks[i], cfg, None, y, fused)
            continue
        if y is not None:
            x = x + y
        j = apps[i]
        t = shared_decode(params, p["hybrid"], j, x, e0, shared_cache(j),
                          index, positions, cfg, fused, lengths)
        _, h = tfm.add_norm(x, t, p["norm1"], cfg, fused)
        state = layer_cache(i)["ssm"]
        y, _ = m2.mamba2_decode(p["mamba"], h, cfg, state,
                                kernel=cfg.use_pallas_decode, out=state,
                                fused=fused)
    return x, y
