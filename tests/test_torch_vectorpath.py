"""The port's vector engine against its fast engine and the reference's.

``serving/vectorpath.py`` is a NumPy copy of the reference's, so the
cases of ``tests/test_vectorpath.py`` run here on the port:
``VectorSimRunner`` replays the ``FastSimRunner`` event stream bit for
bit (decision stream, buckets, report floats, core-seconds) on every
plain scenario, for every policy family it accepts and at sub-second
ticks; and the same inputs through both packages give the same runs and
event counts, with no float tolerance.  The vector legs of
``tests/test_determinism.py`` close the file.  Everything here runs on
the CPU.
"""
import numpy as np
import pytest

from repro.core.baselines import SpongePolicy as JSpongePolicy
from repro.core.baselines import StaticPolicy as JStaticPolicy
from repro.core.perf_model import yolov5s_like as jyolov5s_like
from repro.core.scaler import SpongeScaler as JSpongeScaler
from repro.serving import scenarios as jax_scenarios
from repro.serving import vectorpath as jvectorpath
from repro_torch.core.baselines import SpongePolicy, StaticPolicy
from repro_torch.core.monitor import RateEstimator, tick_window_rate
from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.slo import Decision
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C, MemoizedSolver
from repro_torch.serving.api import ScenarioRunner, SimBackend
from repro_torch.serving.fastpath import FastSimRunner
from repro_torch.serving.reference import ReferenceRunner
from repro_torch.serving.scenarios import build_scenario, run_scenario
from repro_torch.serving.vectorpath import VectorSimRunner

PERF = yolov5s_like()
JPERF = jyolov5s_like()
PLAIN = ["steady", "diurnal", "flash-crowd", "network-replay", "mixed-slo"]


def _policy(kind, tick, jax=False):
    sp, sc, stp, perf = ((JSpongePolicy, JSpongeScaler, JStaticPolicy, JPERF)
                         if jax else (SpongePolicy, SpongeScaler,
                                      StaticPolicy, PERF))
    if kind == "memo":
        return sp(sc(perf, solver="memo", adaptation_interval=tick,
                     budget_quantum=0.01, lam_quantum=0.5))
    if kind == "exact":
        return sp(sc(perf, adaptation_interval=tick))
    return stp(perf, cores=16, b_set=DEFAULT_B, interval=tick)


def _runner(cls, kind, tick, prior):
    jax = cls is jvectorpath.VectorSimRunner
    return cls(_policy(kind, tick, jax), JPERF if jax else PERF, DEFAULT_C,
               DEFAULT_B, c0=16, tick=tick, prior_rps=prior)


def _f(x):
    return "nan" if isinstance(x, float) and np.isnan(x) else x


def _sig(rep, runner):
    """Everything the equivalence contract covers, floats unrounded."""
    decs = [(t, d.c, d.b, getattr(d, "n", 1), d.feasible)
            for t, d in (rep.decisions or [])]
    return (decs, runner.bucket_log, runner.core_samples,
            rep.core_seconds, rep.n_violations, rep.violation_rate,
            rep.avg_cores, _f(rep.p50), _f(rep.p99), rep.buckets,
            _f(rep.mean_latency), rep.n_requests)


def _all(batch, meta, kind, tick, jbatch=None):
    """The port's fast and vector engines and the reference's vector
    engine on the same workload; returns the three signatures and the
    two vector runners' event counts."""
    prior = meta.get("rps") or meta.get("expected_rps") or 20.0
    fast = _runner(FastSimRunner, kind, tick, prior)
    vec = _runner(VectorSimRunner, kind, tick, prior)
    jvec = _runner(jvectorpath.VectorSimRunner, kind, tick, prior)
    sigs = (_sig(fast.run(batch), fast), _sig(vec.run(batch), vec),
            _sig(jvec.run(batch if jbatch is None else jbatch), jvec))
    return sigs, (vec.events_processed, jvec.events_processed)


@pytest.mark.parametrize("name", PLAIN)
@pytest.mark.parametrize("kind", ["memo", "exact", "static"])
def test_bit_identical_to_fastpath(name, kind):
    """The headline contract on every plain scenario, and the
    reference's vector engine on the reference's build."""
    batch, meta = build_scenario(name, duration=60, seed=11)
    jbatch, _ = jax_scenarios.build_scenario(name, duration=60, seed=11)
    (f, v, jv), (ev, jev) = _all(batch, meta, kind,
                                 meta.get("tick") or 1.0, jbatch)
    assert f == v == jv
    assert ev == jev


@pytest.mark.parametrize("tick", [0.25, 0.1, 0.05])
def test_bit_identical_at_subsecond_ticks(tick):
    """Sub-second adaptation cadence, memoized solver, batched decision
    lookups on the hot path."""
    batch, meta = build_scenario("steady", duration=45, seed=7)
    (f, v, jv), (ev, jev) = _all(batch, meta, "memo", tick)
    assert f == v == jv
    assert ev == jev


def test_bit_identical_nonmono_deadline_merge():
    """mixed-slo interleaves deadlines (the argsort + searchsorted +
    insert merge path, not the append path)."""
    batch, meta = build_scenario("mixed-slo", duration=90, seed=3)
    assert np.any(np.diff(np.asarray(batch.deadline)) < 0), \
        "scenario must exercise the non-monotone merge"
    (f, v, jv), (ev, jev) = _all(batch, meta, "memo", 0.25)
    assert f == v == jv
    assert ev == jev


def test_two_runs_identical_and_engine_routing():
    """engine='vector' routes through run_scenario and is run-to-run
    deterministic; its report matches engine='fast' bit for bit and the
    reference's engine='vector' run."""
    kw = dict(duration=45, seed=11)
    r1, s1 = run_scenario("steady", engine="vector", **kw)
    r2, s2 = run_scenario("steady", engine="vector", **kw)
    rf, _ = run_scenario("steady", engine="fast", **kw)
    jr, js = jax_scenarios.run_scenario("steady", engine="vector", **kw)
    assert s1["engine"] == "vector" == js["engine"]
    assert s1["events"] == s2["events"] == js["events"]
    assert s1["solver"] == js["solver"]
    for a, b in ((r1, r2), (r1, rf), (r1, jr)):
        assert [(t, d.c, d.b) for t, d in a.decisions] == \
            [(t, d.c, d.b) for t, d in b.decisions]
        assert (a.buckets, a.n_violations, a.core_seconds) == \
            (b.buckets, b.n_violations, b.core_seconds)
    assert r1.backend == jr.backend == "sim-vector"


@pytest.mark.parametrize("name", ["llm-chat", "fleet-flash-crowd",
                                  "slo-renegotiation", "mixed-zoo"])
def test_vector_engine_rejects_non_plain_scenarios(name):
    """Token, fleet, session and multi-tenant scenarios need their own
    engines — engine='vector' must refuse loudly, not silently
    misreplay, as the reference's does."""
    with pytest.raises(ValueError, match="vector"):
        run_scenario(name, engine="vector", duration=30, seed=1)
    with pytest.raises(ValueError, match="vector"):
        jax_scenarios.run_scenario(name, engine="vector", duration=30,
                                   seed=1)


def test_vectorized_adapter_matches():
    """FastSimRunner.vectorized() hands its exact configuration (policy
    object included, so hand over *before* running either engine) to a
    fresh vector runner that replays identically to a fast run."""
    batch, meta = build_scenario("steady", duration=45, seed=5)
    donor = _runner(FastSimRunner, "memo", 1.0, meta["rps"])
    vec = donor.vectorized()
    assert isinstance(vec, VectorSimRunner)
    assert (vec.tick, vec.c_set, vec.b_set, vec.resize_penalty,
            vec.dispatch_margin, vec.prior_rps, vec.rate_window) == \
        (donor.tick, donor.c_set, donor.b_set, donor.resize_penalty,
         donor.dispatch_margin, donor.prior_rps, donor.rate_window)
    fast = _runner(FastSimRunner, "memo", 1.0, meta["rps"])
    f = fast.run(batch)
    v = vec.run(batch)
    assert _sig(f, fast) == _sig(v, vec)


def test_explicit_horizon_and_empty_batch():
    batch, meta = build_scenario("steady", duration=40, seed=2)
    fast = _runner(FastSimRunner, "memo", 1.0, meta["rps"])
    vec = _runner(VectorSimRunner, "memo", 1.0, meta["rps"])
    jvec = _runner(jvectorpath.VectorSimRunner, "memo", 1.0, meta["rps"])
    assert _sig(fast.run(batch, horizon=25.0), fast) == \
        _sig(vec.run(batch, horizon=25.0), vec) == \
        _sig(jvec.run(batch, horizon=25.0), jvec)
    empty = batch.head(0)
    rep = _runner(VectorSimRunner, "memo", 1.0, 20.0).run(empty)
    assert rep.n_requests == 0 and rep.n_violations == 0


def test_horizontal_policy_rejected():
    """Decision.n > 1 (FA2-style horizontal targets) is out of scope."""
    class Horizontal:
        decisions = None

        def due(self, now):
            return True

        def decide(self, now, queue, lam, initial_wait=0.0):
            return Decision(c=8, b=8, feasible=True, n=2)

    batch, _ = build_scenario("steady", duration=10, seed=1)
    vec = VectorSimRunner(Horizontal(), PERF, DEFAULT_C, DEFAULT_B, c0=16)
    with pytest.raises(NotImplementedError, match="horizontal"):
        vec.run(batch)


def test_events_processed_counts_control_events():
    batch, meta = build_scenario("steady", duration=30, seed=9)
    vec = _runner(VectorSimRunner, "memo", 1.0, meta["rps"])
    vec.run(batch)
    n_batches = len(vec.bucket_log)
    n_ticks = len(vec.core_samples)
    assert vec.events_processed == len(batch) + n_ticks + n_batches
    # the fast engine's run has the same arrivals, ticks and launches
    fast = _runner(FastSimRunner, "memo", 1.0, meta["rps"])
    fast.run(batch)
    assert vec.events_processed == \
        len(batch) + len(fast.core_samples) + len(fast.bucket_log)


def test_queue_mirror_stays_in_sync():
    """The Python-float mirror that feeds the front-cache key tracks the
    live array region through appends, inserts, merges and pops."""
    batch, meta = build_scenario("mixed-slo", duration=60, seed=13)
    vec = _runner(VectorSimRunner, "memo", 0.5, meta["expected_rps"])
    vec.run(batch)
    assert vec._q_dll == vec._q_dl[vec._qh:vec._qt].tolist()
    view = vec._view
    assert len(view) == vec._qt - vec._qh
    np.testing.assert_array_equal(view.remaining_array(3.0),
                                  vec._q_dl[vec._qh:vec._qt] - 3.0)


def test_tick_window_rate_matches_rate_estimator():
    """The tick-granular estimator equals the per-arrival RateEstimator
    at every tick time, on arrival streams with idle gaps, bursts and a
    deploy prior."""
    from repro.core.monitor import tick_window_rate as jtick
    rng = np.random.default_rng(4)
    arr = np.sort(rng.uniform(0.0, 30.0, 400))
    arr = np.concatenate([arr, np.sort(45.0 + rng.uniform(0, 5, 50))])
    for prior in (0.0, 15.0):
        est = RateEstimator(window_s=2.0, prior_rps=prior)
        w0 = jw0 = 0
        k = 0
        for now in np.arange(0.0, 55.0, 0.25):
            while k < arr.size and arr[k] <= now:
                est.observe(float(arr[k]))
                k += 1
            lam_obj = est.rate(float(now))
            lam_arr, w0 = tick_window_rate(arr, w0, float(now), 2.0,
                                           prior)
            jlam, jw0 = jtick(arr, jw0, float(now), 2.0, prior)
            assert lam_obj == lam_arr == jlam, (now, prior)


def test_solve_many_elementwise_identical():
    from repro.core.solver import MemoizedSolver as JMemoizedSolver
    rng = np.random.default_rng(8)
    solver = MemoizedSolver(PERF, DEFAULT_C, DEFAULT_B,
                            budget_quantum=0.01, lam_quantum=0.5)
    seq = MemoizedSolver(PERF, DEFAULT_C, DEFAULT_B,
                         budget_quantum=0.01, lam_quantum=0.5)
    jsolver = JMemoizedSolver(JPERF, DEFAULT_C, DEFAULT_B,
                              budget_quantum=0.01, lam_quantum=0.5)
    rems = [np.sort(rng.uniform(0.0, 1.0, rng.integers(0, 12)))
            for _ in range(60)]
    lams = rng.uniform(1.0, 40.0, 60)
    iws = rng.uniform(0.0, 0.4, 60)
    batch = solver.solve_many(rems, lams, iws)
    single = [seq.solve(r, float(l), initial_wait=float(w))
              for r, l, w in zip(rems, lams, iws)]
    jbatch = jsolver.solve_many(rems, lams, iws)
    key = [(d.c, d.b, d.feasible, d.solver_iters) for d in batch]
    assert key == [(d.c, d.b, d.feasible, d.solver_iters) for d in single]
    assert key == [(d.c, d.b, d.feasible, d.solver_iters) for d in jbatch]
    assert solver.hits + solver.misses == 60
    assert (solver.hits, solver.misses) == (jsolver.hits, jsolver.misses)
    assert [(d.c, d.b) for d in solver.solve_many(rems[:5], lams[:5])] \
        == [(d.c, d.b) for d in jsolver.solve_many(rems[:5], lams[:5])]


# --------------------------------------------------------------------------
# determinism: the vector legs of tests/test_determinism.py
# --------------------------------------------------------------------------
def _det_sig(report):
    return ([(t, d.c, d.b, d.n, d.feasible)
             for t, d in (report.decisions or [])], report.buckets,
            report.n_requests, report.n_violations, report.core_seconds)


@pytest.mark.parametrize("name", ["steady", "mixed-slo"])
def test_same_seed_identical_across_engines(name):
    """reference loop == streamed runner == fastpath == vectorpath on the
    same scenario build."""
    batch, meta = build_scenario(name, duration=60, seed=20240601)
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
    vec = VectorSimRunner(policy(), PERF, DEFAULT_C, DEFAULT_B, c0=16,
                          tick=tick, prior_rps=prior)
    sigs = [_det_sig(r) for r in (ref.run(batch.to_requests()),
                                  new.run(batch.to_requests()),
                                  fast.run(batch), vec.run(batch))]
    assert sigs[0] == sigs[1] == sigs[2] == sigs[3]


@pytest.mark.parametrize("name,engine", [
    ("steady", "vector"), ("mixed-slo", "vector"),
    ("replica-failure", "fast"), ("replica-failure", "exact"),
    ("fleet-flash-crowd", "fast"),
])
def test_two_consecutive_runs_identical(name, engine):
    """The vector and fleet engines are run-to-run deterministic at
    equal seed, and their run is the reference's."""
    kw = dict(engine=engine, duration=45, seed=20240601)
    r1, s1 = run_scenario(name, **kw)
    r2, s2 = run_scenario(name, **kw)
    assert _det_sig(r1) == _det_sig(r2)
    assert (r1.p50, r1.p99) == (r2.p50, r2.p99)
    assert s1["events"] == s2["events"]
    jr, js = jax_scenarios.run_scenario(name, **kw)
    assert _det_sig(r1) == _det_sig(jr)
    assert s1["events"] == js["events"]
    assert s1.get("max_replicas") == js.get("max_replicas")
