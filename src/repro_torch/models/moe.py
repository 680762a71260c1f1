"""Mixture-of-Experts layer: routing, sort-based capacity dispatch, the
batched expert SwiGLU and the weighted combine, on one shard
(``moe_fwd``) or expert-parallel over a mesh (``moe_fwd_ep``, with the
partial-sum serving path ``_moe_fwd_partial_ep``).

Counterpart of ``repro.models.moe`` (``init_moe``, ``route_topk``,
``load_balance_aux``, ``capacity_for``, ``_expert_ffn``,
``_dispatch_compute_combine``, ``moe_fwd``, ``moe_fwd_ep`` and
``_moe_fwd_partial_ep``), with the reference's float expressions term
for term.  The expert-parallel bodies run per rank under ``local_map``
with functional collectives in the reference's order
(``models.sharding``).  The reference computes every piece
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


def _dispatch(ids: torch.Tensor, w: torch.Tensor, capacity: int, e_lo,
              e_local: int):
    """The sort-based capacity dispatch of ``_dispatch_compute_combine``:
    ``(order, slot, s_tok, weight, trash)`` -- the dispatch permutation of
    the flat (token, slot) pairs, each sorted pair's buffer row (the
    trash row ``trash`` for dropped and non-local pairs), its token and
    its f32 combine weight (0 where dropped)."""
    t, k = ids.shape
    dev = ids.device
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
    return order, slot, s_tok, s_w * keep.float(), trash


def _gather_in(x: torch.Tensor, slot, s_tok, rows: int) -> torch.Tensor:
    """The dispatch buffer (rows, d) without its trash row: each kept
    pair's token row at its slot."""
    buf = torch.zeros((rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    buf[slot] = x[s_tok]
    return buf[:-1]


def _combine(yb: torch.Tensor, order, slot, weight, trash: int, t: int
             ) -> torch.Tensor:
    """The deterministic combine (f32, (t, d)): each sorted pair's
    weighted expert row back to its token-major place through the inverse
    permutation, then each token's k contributions summed."""
    tk = order.shape[0]
    contrib = yb[torch.clamp(slot, max=trash - 1)].float()
    contrib = contrib * weight[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk, device=order.device)
    return contrib[inv].reshape(t, tk // t, -1).sum(dim=1)


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
    order, slot, s_tok, weight, trash = _dispatch(ids, w, capacity, e_lo,
                                                  e_local)
    xb = _gather_in(x, slot, s_tok, trash).reshape(e_local, capacity, d)
    yb = _expert_ffn(wg, wu, wd, xb).reshape(e_local * capacity, d)
    return _combine(yb, order, slot, weight, trash, t).to(x.dtype)


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


PARTIAL_EP_MAX_TOKENS = 4096


def _global_aux(probs: torch.Tensor, ids: torch.Tensor, num_experts: int,
                mesh, data_axes) -> torch.Tensor:
    """``load_balance_aux`` over the tokens of every data rank: the
    expert counts and the probability sums are summed over the data
    axes first, so the loss is the single-device one (the reference's
    ``moe_fwd_ep`` averages each rank's own estimate instead)."""
    from repro_torch.models import sharding as sh

    t, k = ids.shape
    flat = ids.reshape(-1)
    f = torch.zeros(num_experts, dtype=torch.float32, device=probs.device)
    f = sh.psum(f.index_add(0, flat, torch.ones(
        flat.shape, dtype=torch.float32, device=probs.device)), mesh,
        data_axes)
    n_tok = t * sh.axis_size(mesh, data_axes)
    f = f / max(n_tok * k, 1)
    p = sh.psum(probs.sum(dim=0), mesh, data_axes) / n_tok
    return num_experts * torch.sum(f * p)


def _ep_specs(data_axes, model_axis):
    """Specs of (tokens, router, router_bias, wg, wu, wd) for the EP
    bodies: tokens over the data axes, experts over ``model_axis``,
    the expert weights' d_model dim over the data axes."""
    return ((data_axes, None), (), (), (model_axis, data_axes, None),
            (model_axis, data_axes, None), (model_axis, None, data_axes))


def moe_fwd_ep(params, x: torch.Tensor, cfg: ModelConfig, mesh,
               data_axes: tuple, model_axis: str):
    """Expert-parallel MoE under ``local_map``.  x: (B, S, d), its batch
    over ``data_axes``.  Returns (y, aux_loss).

    Each rank all-gathers its experts' d_model slices over the data
    axes (ZeRO-3), routes its own tokens, computes the experts
    ``[e_lo, e_lo + e_local)`` of its ``model`` coordinate and the model
    ranks' partial outputs are summed.  The capacity is per data rank,
    as the reference's; the aux loss is over all tokens
    (``_global_aux``)."""
    from repro_torch.models import sharding as sh

    b, s, d = x.shape
    n_data = sh.axis_size(mesh, data_axes)
    n_model = sh.axis_size(mesh, model_axis)
    e_local = cfg.num_experts // n_model
    if (cfg.moe_partial_ep and b * s <= PARTIAL_EP_MAX_TOKENS
            and d % n_data == 0):
        return _moe_fwd_partial_ep(params, x, cfg, mesh, data_axes,
                                   model_axis)
    t_local = (b * s) // n_data
    cap = capacity_for(t_local, cfg.num_experts_per_tok, cfg.num_experts,
                       cfg.moe_capacity_factor)

    def shard_fn(xt, router, router_bias, wg, wu, wd):
        # xt: (T_local, d); wg/wu/wd: (E_local, d/n_data, f) -> FSDP gather
        wg = sh.all_gather(wg, mesh, data_axes, 1)
        wu = sh.all_gather(wu, mesh, data_axes, 1)
        wd = sh.all_gather(wd, mesh, data_axes, 2)
        # gradients: each model rank adds its own experts' part to x's and
        # the router's, each data rank its own tokens' part to the
        # router's; the aux loss, the same on every model rank, is
        # counted once over them
        xt = sh.copy_to(xt, mesh, model_axis)
        router = sh.copy_to(router, mesh, data_axes + (model_axis,))
        logits = xt.float() @ router
        w, ids, probs = route_topk(logits, router_bias,
                                   cfg.num_experts_per_tok,
                                   cfg.moe_router_kind)
        aux = sh.scale_grad(_global_aux(probs, ids, cfg.num_experts, mesh,
                                        data_axes), 1.0 / n_model)
        e_lo = sh.axis_index(mesh, model_axis) * e_local
        y = _dispatch_compute_combine(xt, ids, w, wg, wu, wd, cap, e_lo,
                                      e_local)
        return sh.psum(y, mesh, model_axis), aux

    with sh.mesh_scope(mesh):
        xt = x.reshape(b * s, d)
        y, aux = sh.local_call(
            shard_fn, mesh, _ep_specs(data_axes, model_axis),
            [(data_axes, None), ()], xt, params["router"],
            params["router_bias"], params["wg"], params["wu"], params["wd"],
            partial_grads=False)
        if "shared" in params:
            y = y + mlp_fwd(params["shared"], xt, "swiglu")
        return y.reshape(b, s, d), aux


def _moe_fwd_partial_ep(params, x: torch.Tensor, cfg: ModelConfig, mesh,
                        data_axes: tuple, model_axis: str):
    """Serving-path MoE: d-sliced partial-sum expert compute.

    Every rank keeps its resident (E/n_model, d/n_data, f) weight slice
    and computes partial products over its d-slice; the token
    activations move instead:

        all-gather tokens over data
        partial h/u = x_slice @ w_slice ; psum over data
        y_slice = a @ wd_slice        ; psum over model + gather d over data

    The combine is the deterministic one of ``_combine`` (the reference
    adds with a scatter).  A serving path: forward only, as the
    reference uses it (``moe_fwd_ep`` takes it for at most
    ``PARTIAL_EP_MAX_TOKENS`` tokens under ``cfg.moe_partial_ep``)."""
    from repro_torch.models import sharding as sh

    b, s, d = x.shape
    t = b * s
    n_data = sh.axis_size(mesh, data_axes)
    n_model = sh.axis_size(mesh, model_axis)
    e_local = cfg.num_experts // n_model
    d_shard = d // n_data
    t_local = t // n_data
    cap = capacity_for(t, cfg.num_experts_per_tok, cfg.num_experts,
                       cfg.moe_capacity_factor)

    def shard_fn(xt_local, router, router_bias, wg, wu, wd):
        # xt_local: (T_local, d); w*: (E_local, d_shard, f) resident slices
        xt = sh.all_gather(xt_local, mesh, data_axes, 0)
        logits = xt.float() @ router
        w, ids, probs = route_topk(logits, router_bias,
                                   cfg.num_experts_per_tok,
                                   cfg.moe_router_kind)
        aux = load_balance_aux(probs, ids, cfg.num_experts)
        e_lo = sh.axis_index(mesh, model_axis) * e_local
        didx = sh.axis_index(mesh, data_axes)
        order, slot, s_tok, weight, trash = _dispatch(ids, w, cap, e_lo,
                                                      e_local)
        x_sliced = xt[:, didx * d_shard:(didx + 1) * d_shard]
        xb = _gather_in(x_sliced, slot, s_tok, trash).reshape(
            e_local, cap, d_shard)
        h = sh.psum(torch.bmm(xb.float(), wg.float()), mesh, data_axes)
        u = sh.psum(torch.bmm(xb.float(), wu.float()), mesh, data_axes)
        a = (F.silu(h) * u).to(xt.dtype)
        # wd stored (E_local, f, d) sharded over data on the LAST dim
        yb = torch.bmm(a.float(), wd.float()).reshape(e_local * cap, d_shard)
        y_slice = sh.psum(_combine(yb, order, slot, weight, trash, t), mesh,
                          model_axis)
        y_full = sh.all_gather(y_slice, mesh, data_axes, 1)
        y_mine = y_full[didx * t_local:(didx + 1) * t_local]
        return y_mine.to(xt.dtype), aux

    with sh.mesh_scope(mesh):
        xt = x.reshape(t, d)
        y, aux = sh.local_call(
            shard_fn, mesh, _ep_specs(data_axes, model_axis),
            [(data_axes, None), ()], xt, params["router"],
            params["router_bias"], params["wg"], params["wu"], params["wd"])
        if "shared" in params:
            y = y + mlp_fwd(params["shared"], xt, "swiglu")
        return y.reshape(b, s, d), aux
