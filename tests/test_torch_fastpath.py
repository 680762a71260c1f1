"""The port's struct-of-arrays engines against the JAX package.

``serving/fastpath.py``, ``serving/reference.py``, ``serving/simulator.py``
and the fast queues, λ windows and ``generate_batch`` they run on are
NumPy copies of the reference's, so the same workload gives the same
run, float for float:

* ``FastSimRunner`` == the port's verbatim pre-refactor
  ``ReferenceRunner`` == the streamed ``ScenarioRunner`` == the
  reference's ``FastSimRunner`` (sponge, FA2, static; seeds 3 and 11),
  the memoized solver at quantum 0 included (``tests/test_fastpath.py``);
* the ``FixedWorkCostModel`` adapter through every loop;
* ``TokenFastSimRunner`` == the reference's on the token scenarios;
* ``test_determinism.py``'s cross-engine and two-run cases on the
  ported engines;
* the deprecated ``ClusterSimulator`` shim (``test_simulator.py``).

Everything here runs on the CPU.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from repro.core.baselines import FA2Policy as JFA2Policy
from repro.core.baselines import SpongePolicy as JSpongePolicy
from repro.core.baselines import StaticPolicy as JStaticPolicy
from repro.core.cost_model import FixedWorkCostModel as JFixedWorkCostModel
from repro.core.perf_model import yolov5s_like as jyolo
from repro.core.scaler import SpongeScaler as JSpongeScaler
from repro.core.scaler import TokenSpongeScaler as JTokenSpongeScaler
from repro.network.traces import synth_4g_trace as jsynth_4g_trace
from repro.serving import fastpath as jfastpath
from repro.serving import scenarios as jax_scenarios
from repro.serving.workload import WorkloadGenerator as JWorkloadGenerator
from repro_torch.core import monitor
from repro_torch.core.baselines import FA2Policy, SpongePolicy, StaticPolicy
from repro_torch.core.cost_model import FixedWorkCostModel
from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.queueing import FastEDFQueue, TokenFastEDFQueue
from repro_torch.core.scaler import SpongeScaler, TokenSpongeScaler
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving.api import ScenarioRunner, SimBackend
from repro_torch.serving.fastpath import (FastSimRunner, TokenFastSimRunner,
                                          build_bucket_array)
from repro_torch.serving.reference import ReferenceRunner
from repro_torch.serving.scenarios import build_scenario, run_scenario
from repro_torch.serving.workload import WorkloadGenerator

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.serving import simulator as jsimulator
    from repro_torch.serving import simulator

PERF = yolov5s_like()
JPERF = jyolo()
SEED = 11


def _batch(seed=3, rps=20, duration=90, poisson=True, jax=False):
    traces = jsynth_4g_trace if jax else synth_4g_trace
    gen = JWorkloadGenerator if jax else WorkloadGenerator
    trace = traces(duration, seed=seed)
    wl = gen(rps=rps, slo=1.0, size_kb=200, poisson=poisson, seed=seed)
    return wl.generate_batch(trace)


def _policy(name, solver="bruteforce", jax=False, perf=None):
    if jax:
        perf = JPERF if perf is None else perf
        sponge, fa2, static, scaler = (JSpongePolicy, JFA2Policy,
                                       JStaticPolicy, JSpongeScaler)
    else:
        perf = PERF if perf is None else perf
        sponge, fa2, static, scaler = (SpongePolicy, FA2Policy,
                                       StaticPolicy, SpongeScaler)
    if name == "sponge":
        return sponge(scaler(perf, solver=solver))
    if name == "fa2":
        return fa2(perf, slo=1.0, expected_rps=20)
    return static(perf, cores=8)


def _sig(report):
    """Everything that must match across runners (``test_fastpath.py``;
    exact float equality)."""
    decisions = [(t, d.c, d.b, d.n, d.scale_up_delay, d.feasible)
                 for t, d in (report.decisions or [])]
    return (decisions, report.buckets, report.n_requests,
            report.n_violations, report.core_seconds, report.p50,
            report.p99, report.core_timeline)


def _run_reference(policy, reqs, perf=PERF):
    r = ReferenceRunner(policy, SimBackend(perf, DEFAULT_C, DEFAULT_B,
                                           c0=16))
    r.monitor.rate.prior_rps = 20
    return r.run(reqs)


def _jax_fast(policy, batch, perf=JPERF):
    return jfastpath.FastSimRunner(policy, perf, DEFAULT_C, DEFAULT_B,
                                   c0=16, prior_rps=20).run(batch)


# --------------------------------------------------------------------------
# the workload and the engine's building blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("poisson", [True, False])
def test_generate_batch_equals_reference(poisson, jitter):
    kw = dict(rps=20, slo=1.0, size_kb=200, poisson=poisson,
              size_jitter=jitter, seed=5)
    batch = WorkloadGenerator(**kw).generate_batch(synth_4g_trace(60,
                                                                  seed=5))
    ref = JWorkloadGenerator(**kw).generate_batch(jsynth_4g_trace(60,
                                                                  seed=5))
    for f in dataclasses.fields(batch):
        if f.name != "decode_dist":
            np.testing.assert_array_equal(getattr(batch, f.name),
                                          getattr(ref, f.name), f.name)
    # generate() is in send order, the batch in arrival order
    reqs = WorkloadGenerator(**kw).generate(synth_4g_trace(60, seed=5))
    assert sorted((r.arrival, r.deadline, r.size_kb) for r in reqs) == \
        sorted((r.arrival, r.deadline, r.size_kb)
               for r in batch.to_requests())


def test_request_batch_roundtrip():
    batch = _batch(seed=9)
    assert np.all(np.diff(batch.arrival) >= 0), "must be arrival-sorted"
    reqs = batch.to_requests()
    assert len(reqs) == len(batch)
    i = len(batch) // 2
    r = reqs[i]
    assert r.deadline == batch.deadline[i] and r.arrival == batch.arrival[i]
    head = batch.head(10)
    assert len(head) == 10
    assert np.array_equal(head.arrival, batch.arrival[:10])


@pytest.mark.parametrize("b_set", [DEFAULT_B, (1, 2, 4, 8), (3, 5)])
def test_bucket_array_equals_reference(b_set):
    np.testing.assert_array_equal(build_bucket_array(b_set),
                                  jfastpath.build_bucket_array(b_set))


def test_array_window_rates_equal_reference():
    """The three struct-of-arrays λ windows against the reference's, over
    a bursty arrival column, with and without retracted cancels; the
    tick-granular window equals the per-arrival one."""
    from repro.core import monitor as jmonitor
    rng = np.random.default_rng(4)
    arr = np.sort(rng.uniform(0.0, 30.0, 400))
    cancels = np.sort(rng.choice(arr, 60, replace=False)).tolist()
    for prior in (0.0, 12.0):
        ptr = {"plain": 0, "cancel": (0, 0), "tick": 0}
        for now in np.arange(0.5, 31.0, 0.5):
            ai = int(np.searchsorted(arr, now, side="right"))
            got = monitor.array_window_rate(arr, ai, ptr["plain"], now, 5.0,
                                            prior)
            assert got == jmonitor.array_window_rate(
                arr, ai, ptr["plain"], now, 5.0, prior)
            gc = monitor.array_window_rate_cancel_aware(
                arr, ai, *ptr["cancel"][:1], now, 5.0, prior, cancels,
                ptr["cancel"][1])
            assert gc == jmonitor.array_window_rate_cancel_aware(
                arr, ai, *ptr["cancel"][:1], now, 5.0, prior, cancels,
                ptr["cancel"][1])
            gt = monitor.tick_window_rate(arr, ptr["tick"], now, 5.0, prior)
            assert gt == jmonitor.tick_window_rate(arr, ptr["tick"], now,
                                                   5.0, prior)
            assert gt[0] == got[0]
            ptr = {"plain": got[1], "cancel": gc[1:], "tick": gt[1]}


def test_fast_queues_keep_the_top_live_invariant():
    """Re-keys and cancels leave a live root: ``_heap[0]`` is the EDF
    head the inlined dispatch loops read; the snapshots see only live
    entries."""
    q = FastEDFQueue()
    for i, dl in enumerate([3.0, 1.0, 2.0, 5.0, 4.0]):
        q.push(dl, i)
    assert q.update_deadline(1, 6.0) and q._heap[0] == (2.0, 2)
    assert q.cancel(2) and not q.cancel(2)
    assert q._heap[0] == (3.0, 0) and len(q) == 4
    assert q.remaining_array(1.0).tolist() == [2.0, 3.0, 4.0, 5.0]
    assert q.pop_batch(2) == [0, 4] and 1 in q._live and 0 not in q._live
    assert not q.update_deadline(0, 1.0)
    tq = TokenFastEDFQueue()
    tq.bind(np.array([10, 20, 30]), np.array([0.1, 0.05, 0.2]))
    for i, dl in enumerate([2.0, 1.0, 3.0]):
        tq.push(dl, i)
    rem, toks, tbt = tq.token_snapshot(0.5)
    assert rem.tolist() == [0.5, 1.5, 2.5] and toks.tolist() == [20, 10, 30]
    assert tbt == 0.05


# --------------------------------------------------------------------------
# the equivalence contract (tests/test_fastpath.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sponge", "fa2", "static"])
@pytest.mark.parametrize("seed", [3, 11])
def test_runner_matches_reference(name, seed):
    """Streamed-event ScenarioRunner == verbatim pre-refactor loop, in
    both packages."""
    batch = _batch(seed=seed)
    ref = _run_reference(_policy(name), batch.to_requests())
    new = ScenarioRunner(_policy(name),
                         SimBackend(PERF, DEFAULT_C, DEFAULT_B, c0=16))
    new.monitor.rate.prior_rps = 20
    got = new.run(batch.to_requests())
    from repro.serving import api as japi
    from repro.serving.reference import ReferenceRunner as JReference
    jref = JReference(_policy(name, jax=True),
                      japi.SimBackend(JPERF, DEFAULT_C, DEFAULT_B, c0=16))
    jref.monitor.rate.prior_rps = 20
    assert _sig(got) == _sig(ref) == _sig(jref.run(
        _batch(seed=seed, jax=True).to_requests()))


@pytest.mark.parametrize("name", ["sponge", "fa2", "static"])
@pytest.mark.parametrize("seed", [3, 11])
def test_fastpath_matches_reference(name, seed):
    """Struct-of-arrays FastSimRunner == verbatim pre-refactor loop ==
    the reference's FastSimRunner."""
    batch = _batch(seed=seed)
    ref = _run_reference(_policy(name), batch.to_requests())
    fast = FastSimRunner(_policy(name), PERF, DEFAULT_C, DEFAULT_B,
                         c0=16, prior_rps=20)
    got = fast.run(batch)
    jgot = _jax_fast(_policy(name, jax=True), _batch(seed=seed, jax=True))
    assert _sig(got) == _sig(ref) == _sig(jgot)
    assert fast.events_processed > 0


def test_memoized_solver_is_decision_identical_at_quantum_zero():
    """scaler(solver="memo", quanta=0) == scaler(solver="bruteforce")
    through the full control loop, with the reference's cache stats."""
    batch = _batch(seed=5)
    ref = _run_reference(_policy("sponge"), batch.to_requests())
    memo_pol = SpongePolicy(SpongeScaler(PERF, solver="memo"))
    got = FastSimRunner(memo_pol, PERF, DEFAULT_C, DEFAULT_B, c0=16,
                        prior_rps=20).run(batch)
    assert _sig(got) == _sig(ref)
    stats = memo_pol.scaler.solver_stats()
    assert stats["hits"] + stats["misses"] == len(got.decisions or [])
    jpol = _policy("sponge", solver="memo", jax=True)
    _jax_fast(jpol, _batch(seed=5, jax=True))
    assert stats == jpol.scaler.solver_stats()
    assert SpongeScaler(PERF).solver_stats() == {}


def test_fastpath_accepts_only_decide_policies():
    class OnTickOnly:
        def on_tick(self, now, sim):  # pragma: no cover
            pass

    with pytest.raises(TypeError):
        FastSimRunner(OnTickOnly(), PERF, DEFAULT_C, DEFAULT_B)


def test_vectorized_is_not_ported_yet():
    runner = FastSimRunner(_policy("sponge"), PERF, DEFAULT_C, DEFAULT_B)
    with pytest.raises(NotImplementedError, match="6c"):
        runner.vectorized()


@pytest.mark.parametrize("solver", ["bruteforce", "memo"])
@pytest.mark.parametrize("seed", [3, 11])
def test_cost_model_adapter_identical_across_all_loops(solver, seed):
    """scaler(FixedWorkCostModel(perf)) == scaler(perf) through the
    reference loop, the streamed ScenarioRunner and the fast path, and
    the fast path equals the reference's on the adapter."""
    cost = FixedWorkCostModel(PERF)
    batch = _batch(seed=seed)
    ref = _run_reference(_policy("sponge"), batch.to_requests())

    def cost_policy():
        return SpongePolicy(SpongeScaler(cost, solver=solver))

    assert _sig(_run_reference(cost_policy(), batch.to_requests(),
                               perf=cost)) == _sig(ref)
    new = ScenarioRunner(cost_policy(),
                         SimBackend(cost, DEFAULT_C, DEFAULT_B, c0=16))
    new.monitor.rate.prior_rps = 20
    assert _sig(new.run(batch.to_requests())) == _sig(ref)
    fast = FastSimRunner(cost_policy(), cost, DEFAULT_C, DEFAULT_B,
                         c0=16, prior_rps=20)
    got = fast.run(batch)
    jcost = JFixedWorkCostModel(JPERF)
    jgot = _jax_fast(JSpongePolicy(JSpongeScaler(jcost, solver=solver)),
                     _batch(seed=seed, jax=True), perf=jcost)
    assert _sig(got) == _sig(ref) == _sig(jgot)


@pytest.mark.parametrize("seed,rps,duration", [(0, 8.0, 30), (77, 19.5, 55),
                                               (4096, 30.0, 70)])
def test_cost_model_identity_sweep(seed, rps, duration):
    """``test_fastpath.py``'s hypothesis sweep of the adapter identity,
    at three seeded points: any workload, bit-identical decisions,
    buckets and core-seconds."""
    batch = _batch(seed=seed, rps=rps, duration=duration)
    a = FastSimRunner(_policy("sponge"), PERF, DEFAULT_C, DEFAULT_B,
                      c0=16, prior_rps=rps)
    cost = FixedWorkCostModel(PERF)
    b = FastSimRunner(SpongePolicy(SpongeScaler(cost)), cost, DEFAULT_C,
                      DEFAULT_B, c0=16, prior_rps=rps)
    assert _sig(a.run(batch)) == _sig(b.run(batch))


# --------------------------------------------------------------------------
# the token fast engine
# --------------------------------------------------------------------------
def _token_runner(meta, jax=False, uncertainty=None, c0=16):
    scaler_cls, runner_cls = ((JTokenSpongeScaler,
                               jfastpath.TokenFastSimRunner) if jax
                              else (TokenSpongeScaler, TokenFastSimRunner))
    scaler = scaler_cls(meta["cost"], c_set=DEFAULT_C, b_set=DEFAULT_B,
                        adaptation_interval=meta["tick"],
                        uncertainty=uncertainty)
    return runner_cls(scaler, meta["cost"], DEFAULT_C, DEFAULT_B, c0=c0,
                      tick=meta["tick"], prior_rps=meta["expected_rps"],
                      uncertainty=uncertainty)


def _token_sig(rep):
    return (_sig(rep), rep.tokens_served, rep.tokens_per_s,
            rep.ttft_p50, rep.ttft_p99, rep.tbt_violation_rate,
            rep.n_cancelled, rep.mean_latency, rep.backend, rep.policy)


@pytest.mark.parametrize("name,seed", [("llm-chat", 9), ("llm-chat", 2),
                                       ("llm-mixed-len", 4),
                                       ("llm-heavy-tail", 6)])
def test_token_fast_runner_equals_reference(name, seed):
    batch, meta = build_scenario(name, duration=40, seed=seed)
    jbatch, jmeta = jax_scenarios.build_scenario(name, duration=40,
                                                 seed=seed)
    runner = _token_runner(meta)
    rep = runner.run(batch)
    jrunner = _token_runner(jmeta, jax=True)
    jrep = jrunner.run(jbatch)
    assert _token_sig(rep) == _token_sig(jrep)
    assert runner.events_processed == jrunner.events_processed > 0
    assert rep.backend == "token-sim-fast" and rep.tokens_served > 0
    assert runner.policy.solver_stats() == jrunner.policy.solver_stats()


# --------------------------------------------------------------------------
# determinism (tests/test_determinism.py, without its vectorpath leg)
# --------------------------------------------------------------------------
def _det_sig(report):
    return ([(t, d.c, d.b, d.n, d.feasible)
             for t, d in (report.decisions or [])], report.buckets,
            report.n_requests, report.n_violations, report.core_seconds)


@pytest.mark.parametrize("name", ["steady", "mixed-slo"])
def test_same_seed_identical_across_engines(name):
    """reference == streamed == fastpath on the same scenario build, and
    equal to the reference's fast path."""
    batch, meta = build_scenario(name, duration=90, seed=SEED)
    tick, prior = meta.get("tick", 1.0), meta["expected_rps"]

    def policy():
        return SpongePolicy(SpongeScaler(PERF, adaptation_interval=tick))

    ref = ReferenceRunner(policy(), SimBackend(PERF, DEFAULT_C, DEFAULT_B,
                                               c0=16), tick=tick)
    ref.monitor.rate.prior_rps = prior
    new = ScenarioRunner(policy(), SimBackend(PERF, DEFAULT_C, DEFAULT_B,
                                              c0=16), tick=tick)
    new.monitor.rate.prior_rps = prior
    fast = FastSimRunner(policy(), PERF, DEFAULT_C, DEFAULT_B, c0=16,
                         tick=tick, prior_rps=prior)
    jbatch, _ = jax_scenarios.build_scenario(name, duration=90, seed=SEED)
    jfast = jfastpath.FastSimRunner(
        JSpongePolicy(JSpongeScaler(JPERF, adaptation_interval=tick)),
        JPERF, DEFAULT_C, DEFAULT_B, c0=16, tick=tick, prior_rps=prior)
    sigs = [_det_sig(r) for r in (ref.run(batch.to_requests()),
                                  new.run(batch.to_requests()),
                                  fast.run(batch), jfast.run(jbatch))]
    assert sigs[0] == sigs[1] == sigs[2] == sigs[3]


@pytest.mark.parametrize("name,engine", [
    ("steady", "fast"), ("steady", "exact"), ("mixed-slo", "fast"),
    ("llm-chat", "fast"), ("llm-chat", "exact"),
    ("llm-heavy-tail", "fast"), ("llm-heavy-tail", "exact"),
    ("retrieve-then-generate", "fast"),
])
def test_two_consecutive_runs_identical(name, engine):
    """Every ported engine family is run-to-run deterministic at equal
    seed, and its run is the reference's."""
    kw = dict(engine=engine, duration=45, seed=SEED)
    r1, _ = run_scenario(name, **kw)
    r2, _ = run_scenario(name, **kw)
    assert _det_sig(r1) == _det_sig(r2)
    assert (r1.p50, r1.p99, r1.tokens_served) == \
        (r2.p50, r2.p99, r2.tokens_served)
    jr, _ = jax_scenarios.run_scenario(name, **kw)
    assert _det_sig(r1) == _det_sig(jr)


def test_token_fast_engine_decision_determinism():
    kw = dict(engine="fast", duration=40, seed=3)
    r1, s1 = run_scenario("llm-mixed-len", **kw)
    r2, s2 = run_scenario("llm-mixed-len", **kw)
    assert _det_sig(r1) == _det_sig(r2)
    assert r1.ttft_p99 == r2.ttft_p99
    assert r1.tbt_violation_rate == r2.tbt_violation_rate
    assert s1["events"] == s2["events"]
    jr, js = jax_scenarios.run_scenario("llm-mixed-len", **kw)
    assert _token_sig(r1) == _token_sig(jr) and s1["events"] == js["events"]


@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_stochastic_engine_two_run_identity(engine):
    kw = dict(engine=engine, requests=1500, seed=SEED)
    r1, s1 = run_scenario("llm-heavy-tail", **kw)
    r2, s2 = run_scenario("llm-heavy-tail", **kw)
    assert _det_sig(r1) == _det_sig(r2)
    assert r1.n_cancelled == r2.n_cancelled > 0
    assert (r1.ttft_p99, r1.tbt_violation_rate) == \
        (r2.ttft_p99, r2.tbt_violation_rate)
    assert s1["uncertainty"] == s2["uncertainty"]
    jr, js = jax_scenarios.run_scenario("llm-heavy-tail", **kw)
    assert _token_sig(r1) == _token_sig(jr)
    assert s1["uncertainty"] == js["uncertainty"]
    r3, _ = run_scenario("llm-heavy-tail", engine=engine, requests=1500,
                         seed=SEED + 1)
    assert _det_sig(r3) != _det_sig(r1), "different seeds must diverge"


# --------------------------------------------------------------------------
# the deprecated ClusterSimulator shim (tests/test_simulator.py)
# --------------------------------------------------------------------------
def run_policy(policy, trace, rps=20, c0=1, jax=False):
    mod, gen, perf = ((jsimulator, JWorkloadGenerator, JPERF) if jax
                      else (simulator, WorkloadGenerator, PERF))
    wl = gen(rps=rps, slo=1.0, size_kb=200)
    sim = mod.ClusterSimulator(perf, policy, DEFAULT_C, DEFAULT_B, c0=c0)
    sim.monitor.rate.prior_rps = rps
    return sim, sim.run(wl.generate(trace))


@pytest.fixture(scope="module")
def traces():
    return synth_4g_trace(120, seed=7), jsynth_4g_trace(120, seed=7)


def _both(policy_name, traces, c0, **kw):
    sim, res = run_policy(_policy(policy_name, **kw), traces[0], c0=c0)
    _, jres = run_policy(_policy(policy_name, jax=True, **kw), traces[1],
                         c0=c0, jax=True)
    assert _sig(res) == _sig(jres)
    return sim, res


def test_simulator_shim_warns_and_exports():
    import importlib
    with pytest.warns(DeprecationWarning, match="deprecated"):
        importlib.reload(simulator)
    assert simulator.__all__ == jsimulator.__all__
    assert issubclass(simulator.ClusterSimulator, ScenarioRunner)


def test_request_lifecycle_invariants(traces):
    sim, res = _both("sponge", traces, c0=16)
    assert res["n_requests"] > 0
    for r in sim.monitor.completed:
        assert r.start_proc is not None and r.finish is not None
        assert r.start_proc >= r.arrival - 1e-9, "served before arrival"
        assert r.finish > r.start_proc, "zero/negative processing time"


def test_every_request_served_exactly_once(traces):
    sim, res = _both("sponge", traces, c0=16)
    ids = [r.id for r in sim.monitor.completed]
    assert len(ids) == len(set(ids))
    assert res["n_requests"] == len(ids)


def test_core_seconds_accounting(traces):
    sim, res = _both("static", traces, c0=8)
    horizon = max(r.arrival for r in sim.monitor.completed) + 60.0
    assert res["core_seconds"] == pytest.approx(8 * horizon, rel=0.05)


def test_sponge_resizes_happen(traces):
    sim, _ = _both("sponge", traces, c0=16)
    inst = sim.pool[0].instance
    assert len(inst.resizes) > 3, "vertical scaling never engaged"
    assert len({e.c_to for e in inst.resizes}) > 1


def test_fa2_cold_start_delay(traces):
    for jax in (False, True):
        pol = (JFA2Policy(JPERF, slo=1.0, expected_rps=20, cold_start=10.0)
               if jax else FA2Policy(PERF, slo=1.0, expected_rps=20,
                                     cold_start=10.0))
        sim, _ = run_policy(pol, traces[int(jax)], jax=jax)
        started = [s for s in sim.pool if s.ready_at > 0]
        for s in started:
            assert s.ready_at - s.alive_since >= 10.0 - 1e-9


def test_edf_priority_under_pressure():
    """With a starved server, tighter-deadline requests finish first."""
    from repro_torch.core.slo import Request
    sim = simulator.ClusterSimulator(PERF, StaticPolicy(PERF, cores=1),
                                     (1,), DEFAULT_B, c0=1)
    reqs = [Request.make(arrival=1.0, comm_latency=0.01 * i,
                         slo=1.0 + 0.1 * i) for i in range(10)]
    sim.pool[0].busy_until = 2.0
    sim.run(list(reversed(reqs)), horizon=30)
    groups: dict = {}
    for r in sim.monitor.completed:
        groups.setdefault(r.finish, []).append(r.deadline)
    fins = sorted(groups)
    for a, b in zip(fins, fins[1:]):
        assert max(groups[a]) <= min(groups[b]) + 1e-9
    res = simulator.simulate(PERF, StaticPolicy(PERF, cores=8),
                             reqs, DEFAULT_C, DEFAULT_B, c0=8, horizon=30)
    assert res.n_requests == 10
