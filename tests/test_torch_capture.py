"""The port's capture-ready step tables against the JAX package, on the CPU.

On the card each ``(c, b)`` table entry is a CUDA graph, captured at
warm-up over static tensors: the cache index lives on the device, the
prefill fills a static cache it zeroes first, and the token ids stay on
the device between steps.  On the CPU the same entries run eagerly over
the same static tensors, so these tests hold that machinery to the
reference: the index as a 0-dim int32 tensor, a ring buffer stepped
past its wrap, a static cache reused by gang after gang,
``TokenSimBackend`` and the modelled-clock ``TokenTorchBackend``
decision for decision, and the ``llm-mixed-len`` scenario.  Inputs are
drawn with numpy from a seed, weights come from ``params_from_jax``.
Tolerances: logits atol 1e-4 (the reduced models' tests), everything
else exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.cost_model import TokenCostModel as JaxCost
from repro.core.scaler import TokenSpongeScaler as JaxScaler
from repro.core.slo import Request as JaxRequest
from repro.models import build_model as jax_build
from repro.serving import api as japi
from repro.serving import scenarios as jax_scenarios
from repro.serving import token_backend as jax_tb
from repro.serving.workload import RequestBatch as JaxBatch
from repro_torch.configs import get_config
from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.scaler import TokenSpongeScaler
from repro_torch.models import build_model, params_from_jax
from repro_torch.serving import api
from repro_torch.serving import scenarios
from repro_torch.serving import token_backend as tb
from repro_torch.serving.capture import CapturedStep, launch_counts
from repro_torch.serving.workload import RequestBatch, lognormal_lengths

ATOL = 1e-4
ARCHS = ("smollm-135m-reduced", "rwkv6-1.6b-reduced", "zamba2-2.7b-reduced")


def routes(cfg, on=True):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


_REFS = {}


def reference(arch, **overrides):
    """The reference model (kernel routes on) and its key(0) weights,
    with the port's model on the same weights, both on ``overrides``."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _REFS:
        jcfg = dataclasses.replace(routes(jax_config(arch)), **overrides)
        jmodel = jax_build(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        cfg = dataclasses.replace(routes(get_config(arch)), **overrides)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
        _REFS[key] = (jmodel, jparams, build_model(cfg, device="cpu"),
                      params)
    return _REFS[key]


def ids_of(logits, vocab):
    return np.argmax(np.asarray(logits)[:, :vocab], -1).astype(np.int32)


def assert_index(cache, value):
    index = cache["index"]
    assert isinstance(index, torch.Tensor)
    assert index.shape == () and index.dtype == torch.int32
    assert index.device.type == "cpu" and int(index) == value


# --------------------------------------------------------------------------
# the cache index on the device
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_index_is_a_device_int32_scalar(arch):
    jmodel, jparams, model, params = reference(arch)
    vocab = model.cfg.vocab_size
    b, s, steps = 2, 7, 3
    toks = np.random.default_rng(1).integers(0, vocab, (b, s)) \
        .astype(np.int32)
    assert_index(model.init_cache(b, s + steps), 0)
    jl, jc = jmodel.prefill(jparams, {"tokens": toks}, cache_len=s + steps)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache_len=s + steps)
    index = tc["index"]
    assert_index(tc, s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = ids_of(jl, vocab)
    for step in range(steps):
        jl, jc = jmodel.decode_step(jparams, jc, tok[:, None])
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None])
        assert tc["index"] is index              # advanced in place
        assert_index(tc, s + step + 1)
        assert int(jc["index"]) == s + step + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = ids_of(jl, vocab)


@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("s", [5, 11])
def test_ring_buffer_wraps_with_the_device_index(kernel_route, s):
    """zamba2's shared block over a 6-slot window: a prompt of 5 wraps
    the ring while decoding, one of 11 in the prefill already; both
    routes step on past the wrap from the device index, into a static
    cache the prefill fills, against the reference's decode_step."""
    jmodel, jparams, model, params = reference(
        "zamba2-2.7b-reduced", shared_attn_window=6,
        use_pallas_prefill=kernel_route, use_pallas_decode=kernel_route)
    vocab, b, steps = model.cfg.vocab_size, 2, 9
    toks = np.random.default_rng(s).integers(0, vocab, (b, s)) \
        .astype(np.int32)
    cache = model.init_cache(b, s + steps)
    assert cache["shared"]["k"].shape[2] == 6 < s + steps
    jl, jc = jmodel.prefill(jparams, {"tokens": toks}, cache_len=s + steps)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache=cache)
    assert tc is cache
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = ids_of(jl, vocab)
    for step in range(steps):
        jl, jc = jmodel.decode_step(jparams, jc, tok[:, None])
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(tc["shared"][key].numpy(),
                                       np.asarray(jc["shared"][key]),
                                       atol=ATOL)
        assert_index(tc, s + step + 1)
        tok = ids_of(jl, vocab)


# --------------------------------------------------------------------------
# one static cache, gang after gang
# --------------------------------------------------------------------------
def _gang(model, params, toks, steps, cache_len, cache=None):
    """Logits and greedy ids of a prefill and ``steps`` decode steps, in
    a fresh cache of ``cache_len`` positions or in ``cache``."""
    vocab = model.cfg.vocab_size
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  cache_len=cache_len, cache=cache)
        logits, ids = [lg], [lg[:, :vocab].argmax(-1)]
        for _ in range(steps):
            lg, cache = model.decode_step(params, cache, ids[-1][:, None])
            logits.append(lg)
            ids.append(lg[:, :vocab].argmax(-1))
    return torch.stack(logits), torch.stack(ids), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_static_cache_reuse_equals_fresh_caches(arch):
    _, _, model, params = reference(arch)
    rng = np.random.default_rng(7)
    b, s, steps = 3, 9, 4
    first, second = (rng.integers(0, model.cfg.vocab_size, (b, s))
                     .astype(np.int32) for _ in range(2))
    static = model.init_cache(b, s + steps)
    for toks in (first, second, first):
        fresh_logits, fresh_ids, _ = _gang(model, params, toks, steps,
                                           s + steps)
        logits, ids, cache = _gang(model, params, toks, steps, s + steps,
                                   cache=static)
        assert cache["index"] is static["index"]
        assert torch.equal(logits, fresh_logits)
        assert torch.equal(ids, fresh_ids)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_table_entries_reuse_their_gang(arch):
    """The token tables' static gang: prompts of one b prefilled one
    after another give the ids two fresh eager runs give, the ids come
    back in the entry's own token buffer and the cache is the entry's."""
    _, _, model, params = reference(arch)
    b, pl, steps = 2, 6, 3
    pre, dec = tb.build_token_step_fns(model, params, (1, 2), (b,), pl,
                                       max_decode=steps)
    assert pre[(1, b)] is pre[(2, b)] and dec[(1, b)] is dec[(2, b)]
    rng = np.random.default_rng(3)
    seen = set()
    for _ in range(2):
        toks = rng.integers(0, model.cfg.vocab_size, (b, pl)) \
            .astype(np.int32)
        _, want, _ = _gang(model, params, toks, steps, pl + steps + 1)
        tok, cache = pre[(1, b)](toks)
        got = [tb._host(tok)]
        for _ in range(steps):
            nxt, cache = dec[(2, b)](cache, tok)
            assert nxt is tok                    # the ids stay in place
            got.append(tb._host(nxt))
        np.testing.assert_array_equal(np.stack(got), want.numpy())
        seen.add(id(cache))
    assert len(seen) == 1
    with pytest.raises(ValueError, match="gang"):
        dec[(1, b)](model.init_cache(b, pl + steps + 1), tok)


@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_work_entry_returns_a_copy(arch):
    _, _, model, params = reference(arch)
    b, pl, gen = 2, 6, 3
    fn = api.build_llm_step_fns(model, params, (1,), (b,), pl, gen)[(1, b)]
    rng = np.random.default_rng(11)
    outs, wants = [], []
    for _ in range(2):
        toks = rng.integers(0, model.cfg.vocab_size, (b, pl)) \
            .astype(np.int32)
        outs.append(fn(toks))
        wants.append(_gang(model, params, toks, gen, pl + gen)[1][1:].T)
    for out, want in zip(outs, wants):           # the first kept its ids
        assert out.dtype == torch.int32 and out.shape == (b, gen)
        np.testing.assert_array_equal(out.numpy(), want.numpy())


# --------------------------------------------------------------------------
# CapturedStep on the CPU
# --------------------------------------------------------------------------
def test_captured_step_runs_eagerly_on_the_cpu():
    x = torch.zeros(3)
    step = CapturedStep(lambda: x * 2, (x,))
    assert not step.capture and step.graph is None
    np.testing.assert_array_equal(step(np.arange(3.0)).numpy(), [0, 2, 4])
    assert torch.equal(step(torch.ones(3)), torch.full((3,), 2.0))
    assert torch.equal(step(x), torch.full((3,), 2.0))   # x itself: no copy
    assert step.replays == 0 and step.deltas == {}
    with pytest.raises(TypeError):
        step()
    with pytest.raises(ValueError, match="no CUDA graph"):
        CapturedStep(lambda: x, (x,), capture=True)
    assert set(launch_counts()) == {"swa_prefill", "decode_attention",
                                    "rwkv6_scan", "ssd_scan"}


def test_token_backend_warmup_runs_every_entry():
    _, _, model, params = reference(ARCHS[0])
    pre, dec = tb.build_token_step_fns(model, params, (1, 2), (1, 2), 4,
                                       max_decode=2)
    backend = tb.TokenTorchBackend(pre, dec, TokenCostModel.smollm_like(),
                                   prompt_len=4, max_decode=2)
    backend.warmup()
    for b in (1, 2):
        cache = pre[(1, b)](np.zeros((b, 4), np.int32))[1]
        assert_index(cache, 4)


# --------------------------------------------------------------------------
# TokenSimBackend and the modelled clock
# --------------------------------------------------------------------------
def _token_batch(cls, n, duration, seed, tbt=0.08):
    """``tests/test_token_serving.py``'s token batch."""
    rng = np.random.default_rng(seed)
    send = np.sort(rng.uniform(0, duration, n))
    cl = rng.uniform(0.01, 0.15, n)
    pt = lognormal_lengths(rng, n, median=64, sigma=0.6, lo=8, hi=512)
    dt = lognormal_lengths(rng, n, median=24, sigma=0.5, lo=1, hi=128)
    return cls.from_send(send, cl, slo=1.0, prompt_tokens=pt,
                         decode_tokens=dt, tbt_slo=tbt)


def decision_key(d):
    out = dataclasses.asdict(d)
    out.pop("solver_time")
    return out


@pytest.mark.parametrize("n,duration,seed,tbt", [
    (150, 20.0, 5, 0.08), (80, 10.0, 1, 0.012), (200, 15.0, 9, 0.05)])
def test_token_sim_backend_matches_reference(n, duration, seed, tbt):
    c16 = tuple(range(1, 17))
    cost, jcost = TokenCostModel.smollm_like(), JaxCost.smollm_like()
    batch = _token_batch(RequestBatch, n, duration, seed, tbt)
    jbatch = _token_batch(JaxBatch, n, duration, seed, tbt)
    backend = api.TokenSimBackend(cost, c16, c16, c0=16)
    jbackend = japi.TokenSimBackend(jcost, c16, c16, c0=16)
    runner = api.ScenarioRunner(TokenSpongeScaler(cost), backend)
    jrunner = japi.ScenarioRunner(JaxScaler(jcost), jbackend)
    runner.monitor.rate.prior_rps = jrunner.monitor.rate.prior_rps = 8
    reqs, jreqs = batch.to_requests(), jbatch.to_requests()
    rep, jrep = runner.run(reqs), jrunner.run(jreqs)
    assert rep.decisions and len(rep.decisions) == len(jrep.decisions)
    for (t, d), (jt, jd) in zip(rep.decisions, jrep.decisions):
        assert t == jt and decision_key(d) == decision_key(jd)
    assert rep.buckets == jrep.buckets
    for r, jr in zip(reqs, jreqs):
        assert (r.first_token, r.finish, r.tbt_violations) == \
            (jr.first_token, jr.finish, jr.tbt_violations)
    assert backend.tokens_served == jbackend.tokens_served \
        == rep.tokens_served == jrep.tokens_served == jbatch.total_tokens
    for k in ("n_requests", "n_violations", "ttft_p99", "tbt_violation_rate",
              "p99", "core_seconds"):
        assert rep[k] == jrep[k], k


@pytest.mark.parametrize("scenario,seed", [("llm-chat", 3),
                                           ("llm-mixed-len", 4)])
def test_modelled_token_backend_equals_token_sim_backend(scenario, seed):
    """TokenTorchBackend on the modelled clock serves the same decisions
    and buckets as TokenSimBackend with the same cost, c0, tick and no
    resize penalty (the decode streams clipped to ``max_decode``)."""
    _, _, _, params = reference(ARCHS[0])
    n, pl, md = 10, 8, 3
    batch, meta = scenarios.build_scenario(scenario, requests=n, seed=seed)
    cost, tick = meta["cost"], meta["tick"]
    c_set = b_set = (1, 2, 4)
    runner, backend, cfg, _ = tb.make_token_live_server(
        ARCHS[0], c_set=c_set, b_set=b_set, prompt_len=pl, max_decode=md,
        clock="modeled", tick=tick, prior_rps=meta["expected_rps"],
        cost=cost, params=params, device="cpu")
    sim = api.ScenarioRunner(
        TokenSpongeScaler(cost, c_set=c_set, b_set=b_set,
                          adaptation_interval=tick),
        api.TokenSimBackend(cost, c_set, b_set, c0=max(c_set),
                            resize_penalty=0.0), tick=tick)
    sim.monitor.rate.prior_rps = meta["expected_rps"]
    arr = tb.scenario_arrivals(batch, n, seed, pl, md, cfg.vocab_size)
    sim_reqs = [r for r, _ in tb.scenario_arrivals(batch, n, seed, pl, md,
                                                   cfg.vocab_size)]
    rep, srep = runner.run(arr), sim.run(sim_reqs)
    assert rep.decisions and len(rep.decisions) == len(srep.decisions)
    for (t, d), (st, sd) in zip(rep.decisions, srep.decisions):
        assert t == st and decision_key(d) == decision_key(sd)
    assert rep.buckets == srep.buckets and rep.buckets
    for (r, _), sr in zip(arr, sim_reqs):
        assert (r.first_token, r.finish, r.tbt_violations) == \
            (sr.first_token, sr.finish, sr.tbt_violations)
    assert backend.tokens_served == rep.tokens_served == srep.tokens_served


# --------------------------------------------------------------------------
# llm-mixed-len
# --------------------------------------------------------------------------
@pytest.mark.parametrize("requests,seed", [(8, 3), (48, 0), (500, 11)])
def test_llm_mixed_len_scenario_matches_reference(requests, seed):
    batch, meta = scenarios.build_scenario("llm-mixed-len",
                                           requests=requests, seed=seed)
    jbatch, jmeta = jax_scenarios.build_scenario("llm-mixed-len",
                                                 requests=requests, seed=seed)
    for f in dataclasses.fields(jbatch):
        a, b = getattr(batch, f.name), getattr(jbatch, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert len(np.unique(batch.slo)) == 2 and len(np.unique(batch.tbt_slo)) == 2
    np.testing.assert_equal(dataclasses.asdict(meta["cost"]),
                            dataclasses.asdict(jmeta["cost"]))
    for k in ("slo", "expected_rps", "tbt", "tick", "duration", "rps",
              "token"):
        assert meta[k] == jmeta[k], k
    assert "llm-mixed-len" in scenarios.list_scenarios()


def test_llm_mixed_len_ids_equal_the_reference_backend():
    """Served through run_token_scenario on the CPU (measured clock), and
    through the reference's TokenJaxBackend: every request's greedy ids
    are the same (a row's ids do not depend on the gang it ran in)."""
    n, seed, pl, md = 8, 2, 8, 3
    arch = ARCHS[0]
    params = reference(arch)[3]
    rep, stats = tb.run_token_scenario("llm-mixed-len", arch=arch,
                                       requests=n, seed=seed, prompt_len=pl,
                                       max_decode=md, params=params,
                                       device="cpu")
    jbatch, jmeta = jax_scenarios.build_scenario("llm-mixed-len", requests=n,
                                                 seed=seed)
    jrunner, jbackend, jcfg, _ = jax_tb.make_token_live_server(
        arch, prompt_len=pl, max_decode=md, clock="modeled",
        prior_rps=jmeta["expected_rps"], tick=jmeta["tick"],
        cost=jmeta["cost"])
    rng = np.random.default_rng(seed)
    jarr = []
    for r in jbatch.head(n).to_requests():
        r = JaxRequest.make(arrival=r.arrival, comm_latency=r.comm_latency,
                            slo=r.slo, size_kb=r.size_kb,
                            prompt_tokens=min(r.prompt_tokens, pl),
                            decode_tokens=min(r.decode_tokens, md),
                            tbt_slo=r.tbt_slo)
        jarr.append((r, rng.integers(0, jcfg.vocab_size, r.prompt_tokens)
                     .astype(np.int32)))
    jrep = jrunner.run(jarr)
    gen = stats["generated"]
    ids = [gen[k] for k in sorted(gen)]
    jids = [jbackend.generated[r.id] for r, _ in jarr]
    assert rep.n_requests == jrep.n_requests == len(ids) == len(jarr) > 0
    assert ids == jids
    assert rep.tokens_served == jrep.tokens_served == sum(map(len, ids))
