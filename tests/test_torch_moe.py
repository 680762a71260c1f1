"""The port's MoE layer against the JAX package's, on the CPU.

Mirrors ``tests/test_moe.py`` on the port and holds each piece to the
reference on the same inputs (drawn with numpy from a seed) and the
reference's weights (``init_moe(jax.random.key(0))`` as numpy):
``capacity_for`` equal over a grid; ``route_topk`` ids equal and
weights within 1e-6 (softmax and sigmoid, ties to the lower index);
``moe_fwd`` within 1e-5 at the no-drop capacity factor and at the
served 1.25, where pairs are dropped; the auxiliary loss within 1e-6;
and the expert share: four shares of E / 4 experts, the shared expert
in one of them, add up to the whole layer within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.mlp import mlp_fwd

ATOL = 1e-5


def _tiny(get, **kw):
    cfg = get("kimi-k2-1t-a32b", reduced=True)
    change = dict(num_experts=8, num_experts_per_tok=2, d_model=64,
                  moe_d_ff=32, moe_capacity_factor=8.0)
    return dataclasses.replace(cfg, **dict(change, **kw))


def tiny_cfgs(**kw):
    """The reference test's tiny MoE config, in both packages."""
    return _tiny(get_config, **kw), _tiny(jax_config, **kw)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def layer(jcfg, seed=0):
    """The reference's ``init_moe`` params and the same as tensors."""
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: t(np.asarray(a)), jp)
    return jp, tp


def expert_share(params, e_lo, e_local):
    """The share ``[e_lo, e_lo + e_local)`` of a whole layer's params:
    its expert weights sliced, the router whole, the shared expert when
    the share starts at expert 0 (``init_moe``'s rule)."""
    p = {"router": params["router"], "router_bias": params["router_bias"],
         "expert_lo": torch.tensor(e_lo)}
    for name in ("wg", "wu", "wd"):
        p[name] = params[name][e_lo:e_lo + e_local]
    if e_lo == 0:
        p["shared"] = params["shared"]
    return p


def inputs(b, s, d, seed=1):
    return (np.random.default_rng(seed).standard_normal((b, s, d))
            .astype(np.float32) * 0.5)


# --------------------------------------------------------------------------
# the reference's own cases, on the port
# --------------------------------------------------------------------------
def test_capacity_floor_and_cap():
    assert tmoe.capacity_for(8, 8, 256, 1.25) >= 8     # decode: zero-drop floor
    assert tmoe.capacity_for(1, 2, 4, 1.25) <= 2        # never exceeds t*k
    c = tmoe.capacity_for(65536, 8, 256, 1.25)
    assert c >= 65536 * 8 * 1.25 / 256
    assert c % 4 == 0


@pytest.mark.parametrize("k,e,cf", [(2, 4, 1.25), (2, 4, 4.0), (8, 256, 1.25),
                                    (8, 384, 1.25), (8, 384, 4.0),
                                    (1, 16, 1.0)])
def test_capacity_for_equals_reference(k, e, cf):
    for tokens in (1, 2, 3, 4, 7, 8, 16, 33, 256, 1024, 4096, 65536):
        assert tmoe.capacity_for(tokens, k, e, cf) == \
            jmoe.capacity_for(tokens, k, e, cf), tokens


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
def test_route_topk_matches_reference(kind):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 8)).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32) * 0.1
    w, ids, probs = tmoe.route_topk(t(logits), t(bias), 2, kind)
    jw, jids, jprobs = jmoe.route_topk(jnp.asarray(logits), jnp.asarray(bias),
                                       2, kind)
    assert w.shape == (16, 2) and ids.shape == (16, 2)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert int(ids.max()) < 8
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)


@pytest.mark.parametrize("kind", ["softmax", "sigmoid"])
def test_route_topk_breaks_ties_to_the_lower_index(kind):
    """Equal scores: ``jax.lax.top_k``'s order (lower index first), which
    the port keeps through a stable descending sort."""
    logits = np.zeros((4, 8), np.float32)
    logits[:, 5] = logits[:, 2] = 1.0            # a tie above the rest
    logits[1, 7] = 2.0
    _, ids, _ = tmoe.route_topk(t(logits), torch.zeros(8), 3, kind)
    _, jids, _ = jmoe.route_topk(jnp.asarray(logits), jnp.zeros(8), 3, kind)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids[0].tolist() == [2, 5, 0]


def test_sigmoid_bias_changes_selection_not_weights():
    rng = np.random.default_rng(1)
    logits = t(rng.standard_normal((32, 8)))
    b1 = torch.zeros(8)
    b1[3] = 10.0                                  # strongly favor expert 3
    w1, ids1, _ = tmoe.route_topk(logits, b1, 2, "sigmoid")
    assert (ids1 == 3).any(dim=1).all(), "bias must pull expert 3 in"
    np.testing.assert_allclose(w1.sum(-1).numpy(), 1.0, atol=1e-5)


def test_moe_fwd_no_drop_equals_dense_sum():
    """With no-drop capacity, the port's MoE output equals the explicit
    per-token weighted sum of expert FFNs."""
    cfg, jcfg = tiny_cfgs()
    _, p = layer(jcfg)
    x = t(inputs(2, 6, 64))
    y, _ = tmoe.moe_fwd(p, x, cfg)
    xt = x.reshape(-1, 64)
    w, ids, _ = tmoe.route_topk(xt @ p["router"], p["router_bias"],
                                cfg.num_experts_per_tok, cfg.moe_router_kind)
    ref = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        fe = (torch.nn.functional.silu(xt @ p["wg"][e]) * (xt @ p["wu"][e])
              ) @ p["wd"][e]
        we = torch.where(ids == e, w, 0.0).sum(-1)
        ref = ref + fe * we[:, None]
    ref = ref + mlp_fwd(p["shared"], xt, "swiglu")
    np.testing.assert_allclose(y.reshape(-1, 64).numpy(), ref.numpy(),
                               atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# the layer against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_fwd_matches_reference(cf, router):
    """Output and auxiliary loss at the no-drop factor and at the served
    1.25 (24 tokens x 2 over 8 experts: capacity 8, so the experts that
    draw more than 8 pairs drop the rest, the same pairs in both)."""
    cfg, jcfg = tiny_cfgs(moe_capacity_factor=cf, moe_router_kind=router)
    jp, tp = layer(jcfg, seed=3)
    x = inputs(3, 8, 64, seed=4)
    jy, jaux = jmoe.moe_fwd(jp, jnp.asarray(x), jcfg)
    y, aux = tmoe.moe_fwd(tp, t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    if cf == 1.25:
        # the served factor drops pairs here: the output moves
        full, _ = tmoe.moe_fwd(tp, t(x), dataclasses.replace(
            cfg, moe_capacity_factor=8.0))
        assert tmoe.capacity_for(24, 2, 8, 1.25) == 8
        assert float((full - y).abs().max()) > 1e-2


def test_dispatch_drops_the_reference_pairs():
    """The pairs the capacity keeps, worked out from the routed ids by
    the reference's rule (stable sort by expert, the first ``capacity``
    of each expert), are the pairs whose contribution reaches the
    port's output: the output with only those pairs' weights equals
    the layer's."""
    cfg, jcfg = tiny_cfgs(moe_capacity_factor=1.25)
    _, p = layer(jcfg, seed=5)
    xt = t(inputs(1, 24, 64, seed=6)).reshape(24, 64)
    w, ids, _ = tmoe.route_topk(xt @ p["router"], p["router_bias"], 2,
                                cfg.moe_router_kind)
    cap = tmoe.capacity_for(24, 2, 8, 1.25)
    flat = ids.reshape(-1).numpy()
    order = np.argsort(flat, kind="stable")
    keep = np.zeros(flat.size, bool)
    seen: dict = {}
    for j in order:
        seen[flat[j]] = seen.get(flat[j], 0) + 1
        keep[j] = seen[flat[j]] <= cap
    assert not keep.all()                         # some pairs drop
    y = tmoe._dispatch_compute_combine(xt, ids, w, p["wg"], p["wu"],
                                       p["wd"], cap, 0, 8)
    wk = w * torch.from_numpy(keep.reshape(24, 2)).float()
    y_keep = tmoe._dispatch_compute_combine(xt, ids, wk, p["wg"], p["wu"],
                                            p["wd"], 48, 0, 8)
    np.testing.assert_allclose(y.numpy(), y_keep.numpy(), atol=ATOL)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_four_expert_shares_add_up_to_the_layer(cf):
    """One rank of 4-way expert parallelism each: every share routes over
    all 8 experts and computes its 2; the shared expert goes with the
    first.  The four partial outputs add up to the reference's uncut
    ``moe_fwd``, and each share equals the reference's own contract
    (``_dispatch_compute_combine`` with ``e_lo, e_local``)."""
    cfg, jcfg = tiny_cfgs(moe_capacity_factor=cf)
    jp, tp = layer(jcfg, seed=7)
    x = inputs(2, 12, 64, seed=8)
    jy, _ = jmoe.moe_fwd(jp, jnp.asarray(x), jcfg)
    xt = jnp.asarray(x.reshape(24, 64))
    jw, jids, _ = jmoe.route_topk(xt @ jp["router"], jp["router_bias"], 2,
                                  jcfg.moe_router_kind)
    cap = jmoe.capacity_for(24, 2, 8, cf)
    total = torch.zeros(2, 12, 64)
    for rank in range(4):
        share = expert_share(tp, 2 * rank, 2)
        assert share["wg"].shape == (2, 64, 32)
        assert ("shared" in share) == (rank == 0)
        y, _ = tmoe.moe_fwd(share, t(x), cfg)
        part = jmoe._dispatch_compute_combine(
            xt, jids, jw, jp["wg"][2 * rank:2 * rank + 2],
            jp["wu"][2 * rank:2 * rank + 2], jp["wd"][2 * rank:2 * rank + 2],
            cap, 2 * rank, 2)
        routed = y.reshape(24, 64)
        if rank == 0:
            routed = routed - mlp_fwd(tp["shared"], t(x).reshape(24, 64),
                                      "swiglu")
        np.testing.assert_allclose(routed.numpy(), np.asarray(part),
                                   atol=ATOL)
        total = total + y
    np.testing.assert_allclose(total.numpy(), np.asarray(jy), atol=ATOL)


def test_init_moe_draws_a_share():
    cfg, _ = tiny_cfgs()
    gen = torch.Generator().manual_seed(0)
    whole = tmoe.init_moe(gen, cfg, torch.float32)
    assert whole["wg"].shape == (8, 64, 32) and "expert_lo" not in whole
    share = tmoe.init_moe(gen, cfg, torch.float32, experts=(6, 2))
    assert share["router"].shape == (64, 8)
    assert share["wd"].shape == (2, 32, 64) and int(share["expert_lo"]) == 6
    assert "shared" not in share
    first = tmoe.init_moe(gen, cfg, torch.float32, experts=(0, 2))
    assert "shared" in first and int(first["expert_lo"]) == 0
    with pytest.raises(ValueError):
        tmoe.init_moe(gen, cfg, torch.float32, experts=(6, 4))
    y, aux = tmoe.moe_fwd(share, t(inputs(1, 5, 64)), cfg)
    assert y.shape == (1, 5, 64) and torch.isfinite(y).all()
    assert float(aux) > 0


def test_combine_is_deterministic():
    """The same input twice gives the same bits (the combine sums each
    token's k contributions in one fixed order)."""
    cfg, jcfg = tiny_cfgs(num_experts_per_tok=4)
    _, p = layer(jcfg, seed=9)
    x = t(inputs(2, 16, 64, seed=10))
    a, _ = tmoe.moe_fwd(p, x, cfg)
    b, _ = tmoe.moe_fwd(p, x, cfg)
    assert torch.equal(a, b)
