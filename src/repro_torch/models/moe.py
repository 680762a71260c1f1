"""Mixture-of-Experts layer, single shard: routing, sort-based capacity
dispatch, the batched expert SwiGLU and the weighted combine.

Counterpart of ``repro.models.moe`` (``init_moe``, ``route_topk``,
``load_balance_aux``, ``capacity_for``, ``_expert_ffn``,
``_dispatch_compute_combine`` and ``moe_fwd``), with the reference's
float expressions term for term.  The reference computes every piece
outside any Pallas kernel, and so does this counterpart: the expert
products are batched matrix products (``torch.bmm``).

Three places differ in form, not in value:

* **Top-k.** ``jax.lax.top_k`` breaks ties to the lower index;
  ``torch.topk`` on CUDA promises no order.  The router takes its k
  experts from a stable descending sort, which keeps the lower index
  first among equal scores.
* **The combine.** The reference adds each token's k weighted expert
  outputs into an f32 zero with a scatter-add in the dispatch's sorted
  order.  On CUDA ``index_add_`` adds with atomics, whose f32 order
  changes from run to run.  Here each (token, slot) pair's contribution
  is brought back to its place in the token-major order through the
  inverse of the dispatch permutation and the k contributions of a
  token are summed over the slot axis: a fixed order, the same on every
  run and in a replayed CUDA graph.
* **The expert share.** ``params`` may hold only the experts
  ``[e_lo, e_lo + e_local)`` of the ``E`` the router scores: the
  reference's own contract for one rank of expert parallelism
  (``_dispatch_compute_combine(..., e_lo, e_local)``, which its
  ``moe_fwd_ep`` calls on each model rank).  ``init_moe(experts=(e_lo,
  e_local))`` draws such a share, whose ``"expert_lo"`` (a 0-dim int64
  tensor) says where it starts; ``e_local`` is the experts' leading
  axis (a layer's params sliced along it, with ``"expert_lo"`` added,
  are a share of that layer).  The router still scores all ``E``
  experts and every pair routed outside the share contributes zero.  The
  shared expert goes with the share that starts at expert 0 only, so
  that the shares' outputs of one layer add up to the whole layer's.  Nothing stands in for the
  other ranks: without the exchange between ranks, a share's output is
  its own partial sum.

The capacity is a host int from static shapes (``capacity_for``), so a
step reads nothing back to the host and can be captured as a CUDA
graph; the dispatch buffer keeps the reference's ``e_local * capacity +
1`` rows, the last one the trash row of dropped and non-local pairs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_fwd


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             experts: Optional[Tuple[int, int]] = None):
    """The router over all ``cfg.num_experts`` experts and the expert
    weights of ``experts = (e_lo, e_local)`` (all of them when None);
    the shared expert when the config has one and the share starts at
    expert 0, so that it is counted once over the shares."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dev = gen.device
    e_lo, e_local = (0, e) if experts is None else experts
    if not (0 <= e_lo and 0 < e_local and e_lo + e_local <= e):
        raise ValueError(f"expert share {experts} outside 0..{e}")
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "router_bias": torch.zeros(e, dtype=torch.float32, device=dev),
        "wg": dense_init(gen, (e_local, d, f), dtype, fan_in=d),
        "wu": dense_init(gen, (e_local, d, f), dtype, fan_in=d),
        "wd": dense_init(gen, (e_local, f, d), dtype, fan_in=f),
    }
    if experts is not None:
        p["expert_lo"] = torch.tensor(e_lo, dtype=torch.int64, device=dev)
    if cfg.num_shared_experts and e_lo == 0:
        p["shared"] = init_mlp(gen, d, f * cfg.num_shared_experts, "swiglu",
                               dtype)
    return p


def _top_k(scores: torch.Tensor, k: int):
    """The k largest scores per row and their ids, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def route_topk(logits: torch.Tensor, bias: torch.Tensor, k: int, kind: str):
    """Returns (weights (T, k), ids (T, k), probs (T, E)) for aux loss."""
    if kind == "sigmoid":  # DeepSeek-V3: sigmoid scores, bias only for topk
        scores = torch.sigmoid(logits.float())
        _, ids = _top_k(scores + bias[None, :], k)
        w = torch.gather(scores, -1, ids)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits.float(), dim=-1)
        w, ids = _top_k(probs, k)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids, probs


def load_balance_aux(probs: torch.Tensor, ids: torch.Tensor,
                     num_experts: int) -> torch.Tensor:
    """GShard/Switch aux loss: E * sum_i f_i * P_i (local-batch estimate).
    The counts are whole numbers, exact in f32 in any order of adds."""
    t = probs.shape[0]
    flat = ids.reshape(-1)
    f = torch.zeros(num_experts, dtype=torch.float32, device=probs.device)
    f = f.index_add(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                        device=probs.device))
    f = f / max(t * ids.shape[1], 1)
    p = probs.mean(dim=0)
    return num_experts * torch.sum(f * p)


def capacity_for(tokens: int, k: int, num_experts: int, cf: float) -> int:
    """Static per-shard expert capacity.  Small token counts (decode) get a
    zero-drop floor; large counts get the classic cf-scaled capacity."""
    c = int(math.ceil(tokens * k * cf / num_experts))
    c = max(c, min(tokens * k, 8))
    c = min(c, tokens * k)
    return int(math.ceil(c / 4) * 4) if c > 8 else c


def _expert_ffn(wg, wu, wd, xb: torch.Tensor) -> torch.Tensor:
    """Batched expert SwiGLU: xb (E, C, d) -> (E, C, d).  Each product
    accumulates in f32 and rounds once to xb's dtype."""
    h = torch.bmm(xb, wg)
    u = torch.bmm(xb, wu)
    a = F.silu(h) * u
    return torch.bmm(a, wd)


def _dispatch_compute_combine(x: torch.Tensor, ids: torch.Tensor,
                              w: torch.Tensor, wg, wu, wd, capacity: int,
                              e_lo, e_local: int) -> torch.Tensor:
    """Sort-based capacity dispatch -> expert FFN -> weighted combine.

    x: (T, d); ids/w: (T, k) with GLOBAL expert ids; computes only experts in
    [e_lo, e_lo + e_local) (pass 0, E for the non-EP path; ``e_lo`` may
    be a 0-dim tensor).  Returns the partial output (T, d) (zero
    contribution for non-local / dropped pairs).
    """
    t, d = x.shape
    k = ids.shape[1]
    dev = x.device
    flat_ids = ids.reshape(-1)
    flat_w = w.reshape(-1).float()
    local = (flat_ids >= e_lo) & (flat_ids < e_lo + e_local)
    lids = torch.clamp(flat_ids - e_lo, 0, e_local - 1)

    order = torch.argsort(torch.where(local, lids, e_local), stable=True)
    sid = lids[order]
    s_local = local[order]
    s_w = flat_w[order]
    s_tok = order // k

    counts = torch.zeros(e_local, dtype=torch.int64, device=dev).index_add(
        0, lids, local.long())
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)[:-1]])
    pos = torch.arange(t * k, device=dev) - offsets[sid]
    keep = s_local & (pos < capacity)
    trash = e_local * capacity
    slot = torch.where(keep, sid * capacity + pos, trash)

    buf = torch.zeros((e_local * capacity + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = x[s_tok]
    xb = buf[:-1].reshape(e_local, capacity, d)

    yb = _expert_ffn(wg, wu, wd, xb).reshape(e_local * capacity, d)
    contrib = yb[torch.clamp(slot, max=trash - 1)].float()
    contrib = contrib * (s_w * keep.float())[:, None]
    # the deterministic combine: back to token-major order through the
    # inverse permutation, then each token's k contributions summed
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    y = contrib[inv].reshape(t, k, d).sum(dim=1)
    return y.to(x.dtype)


def moe_fwd(params, x: torch.Tensor, cfg: ModelConfig):
    """Single-shard MoE (reference / smoke / tiny-token path), over the
    experts ``params`` holds (the module docstring's expert share).

    x: (B, S, d).  Returns (y, aux_loss).
    """
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = xt.float() @ params["router"]
    w, ids, probs = route_topk(logits, params["router_bias"],
                               cfg.num_experts_per_tok, cfg.moe_router_kind)
    aux = load_balance_aux(probs, ids, cfg.num_experts)
    cap = capacity_for(b * s, cfg.num_experts_per_tok, cfg.num_experts,
                       cfg.moe_capacity_factor)
    e_local = params["wg"].shape[0]
    y = _dispatch_compute_combine(xt, ids, w, params["wg"], params["wu"],
                                  params["wd"], cap,
                                  params.get("expert_lo", 0), e_local)
    if "shared" in params:
        y = y + mlp_fwd(params["shared"], xt, "swiglu")
    return y.reshape(b, s, d), aux
