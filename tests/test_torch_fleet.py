"""The port's fleet layer against the JAX package's.

``serving/fleet.py``, the joint ``(n, c, b)`` solvers of
``core/solver.py`` and ``FleetSession`` are NumPy copies of the
reference's, so the cases of ``tests/test_fleet.py`` run here on the
port (fast engine == exact gang loop; bruteforce == table == memo; the
``n_set=(1,)`` reduction to Algorithm 1; hysteresis, drain, routers),
and the same inputs through both packages must give the same decision
streams, buckets, report floats, core-seconds, ``max_replicas`` and
event counts, with no float tolerance.  Everything here runs on the CPU.
"""
from bisect import insort

import numpy as np
import pytest
from _hyp import given, settings, st  # guarded hypothesis import

from repro.core import solver as jsolver
from repro.core.perf_model import yolov5s_like as jyolov5s_like
from repro.serving import fleet as jfleet
from repro.serving import scenarios as jax_scenarios
from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.slo import Decision
from repro_torch.core.solver import (DEFAULT_B, DEFAULT_C,
                                     JointMemoizedSolver, JointSolverTable,
                                     joint_candidates, solve_bruteforce,
                                     solve_joint_bruteforce)
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving.fleet import (ROUTERS, FleetExactRunner,
                                       FleetFastSimRunner, FleetSpongeScaler,
                                       StaticFleetPolicy, route_request)
from repro_torch.serving.scenarios import build_scenario, run_scenario
from repro_torch.serving.workload import WorkloadGenerator

PERF = yolov5s_like()
JPERF = jyolov5s_like()
N_SET = (1, 2, 3, 4, 6, 8, 12, 16)
FLEET_SCENARIOS = ("replica-failure", "rolling-restart",
                   "fleet-flash-crowd")


def _f(x):
    """NaN-safe equality for report floats (a run that serves nothing
    reports NaN percentiles)."""
    return "nan" if isinstance(x, float) and np.isnan(x) else x


def _sig(report):
    """Everything that must match across engines and packages (floats
    compared with ``==``: the engines log a launch time as a Python or
    a NumPy float, of equal value)."""
    decisions = [(t, d.c, d.b, d.n, d.scale_up_delay, d.feasible)
                 for t, d in (report.decisions or [])]
    return (decisions, report.buckets, report.n_requests,
            report.n_violations, report.core_seconds, _f(report.p50),
            _f(report.p99), report.core_timeline, report.violation_rate,
            report.avg_cores, _f(report.mean_latency))


def _scaler(**kw):
    return FleetSpongeScaler(PERF, adaptation_interval=0.5, **kw)


def _jscaler(**kw):
    return jfleet.FleetSpongeScaler(JPERF, adaptation_interval=0.5, **kw)


def _dkey(d):
    return (d.c, d.b, d.n, d.feasible, d.solver_iters)


# --------------------------------------------------------------------------
# fleet decision identity: fast == exact == the reference's engines
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", FLEET_SCENARIOS)
def test_fleet_decision_identity_on_scenarios(name):
    """Fast engine == exact gang loop on every fleet scenario, and both
    equal the reference's fast engine on the reference's build."""
    batch, meta = build_scenario(name, duration=90, seed=7)
    jbatch, jmeta = jax_scenarios.build_scenario(name, duration=90, seed=7)
    kw = dict(n0=meta["n0"], c0=meta["c0"], tick=meta["tick"],
              prior_rps=meta["expected_rps"], router=meta["router"])
    fast = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B, **kw)
    exact = FleetExactRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B, **kw)
    jfast = jfleet.FleetFastSimRunner(_jscaler(), JPERF, DEFAULT_C,
                                      DEFAULT_B, **kw)
    got = fast.run(batch, events=meta["fleet_events"])
    ref = exact.run(batch, events=meta["fleet_events"])
    jgot = jfast.run(jbatch, events=jmeta["fleet_events"])
    assert _sig(got) == _sig(ref) == _sig(jgot)
    assert got.n_requests > 0
    assert fast.max_replicas == exact.max_replicas == jfast.max_replicas
    assert fast.events_processed == jfast.events_processed


@pytest.mark.parametrize("router", ROUTERS)
def test_fleet_decision_identity_across_routers(router):
    """Identity holds for every router, with kill + restart events, and
    the exact gang loop equals the reference's."""
    trace = synth_4g_trace(100, seed=3)
    wl = WorkloadGenerator(rps=60, slo=1.0, size_kb=200, poisson=True,
                           seed=3)
    batch = wl.generate_batch(trace, 80)
    events = ((25.0, "kill", 1), (50.0, "restart", 0, 4.0))
    kw = dict(n0=4, c0=16, prior_rps=60, router=router)
    fast = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B, **kw)
    exact = FleetExactRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B, **kw)
    jexact = jfleet.FleetExactRunner(_jscaler(), JPERF, DEFAULT_C,
                                     DEFAULT_B, **kw)
    got = _sig(fast.run(batch, events=events))
    assert got == _sig(exact.run(batch, events=events)) \
        == _sig(jexact.run(batch, events=events))
    assert exact.events_processed == jexact.events_processed


def test_fleet_identity_with_static_policy():
    """The static-fleet baseline is engine-identical too."""
    trace = synth_4g_trace(80, seed=5)
    wl = WorkloadGenerator(rps=40, slo=1.0, size_kb=200, poisson=True,
                           seed=5)
    batch = wl.generate_batch(trace, 60)
    kw = dict(n0=4, c0=8, prior_rps=40)

    def pol():
        return StaticFleetPolicy(PERF, replicas=4, cores=8)

    fast = FleetFastSimRunner(pol(), PERF, DEFAULT_C, DEFAULT_B, **kw)
    exact = FleetExactRunner(pol(), PERF, DEFAULT_C, DEFAULT_B, **kw)
    jfast = jfleet.FleetFastSimRunner(
        jfleet.StaticFleetPolicy(JPERF, replicas=4, cores=8), JPERF,
        DEFAULT_C, DEFAULT_B, **kw)
    assert _sig(fast.run(batch)) == _sig(exact.run(batch)) \
        == _sig(jfast.run(batch))
    assert fast.policy.name == jfast.policy.name == "static-fleet-4x8"


@pytest.mark.parametrize("name", FLEET_SCENARIOS)
@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_run_scenario_fleet_equals_reference(name, engine):
    """``run_scenario`` on a fleet scenario: the same report, decisions,
    ``max_replicas``, router, solver statistics and event count as the
    reference's, at the reference tests' sizes."""
    rep, stats = run_scenario(name, engine=engine, duration=60, seed=5)
    jrep, jstats = jax_scenarios.run_scenario(name, engine=engine,
                                              duration=60, seed=5)
    assert _sig(rep) == _sig(jrep)
    assert rep.policy == jrep.policy and rep.backend == jrep.backend
    for k in ("engine", "events", "max_replicas", "router", "solver"):
        assert stats[k] == jstats[k], k


# --------------------------------------------------------------------------
# joint solver: bruteforce == table == memo, the n=1 reduction, and the
# reference's decisions
# --------------------------------------------------------------------------
budgets = st.lists(st.floats(0.05, 3.0), min_size=0, max_size=40)
lams = st.floats(0.0, 300.0)
waits = st.floats(0.0, 0.5)


@given(budgets, lams, waits)
@settings(deadline=None)
def test_joint_table_agrees_with_bruteforce(rem, lam, wait):
    """The precomputed joint grid is the joint Algorithm 1, vectorized,
    and both are the reference's."""
    tab = JointSolverTable(PERF, n_set=N_SET)
    d1 = solve_joint_bruteforce(rem, lam, PERF, n_set=N_SET,
                                initial_wait=wait)
    d2 = tab.solve(rem, lam, initial_wait=wait)
    j1 = jsolver.solve_joint_bruteforce(rem, lam, JPERF, n_set=N_SET,
                                        initial_wait=wait)
    assert (d1.c, d1.b, d1.n, d1.feasible) == (d2.c, d2.b, d2.n,
                                               d2.feasible)
    assert _dkey(d1) == _dkey(j1)


@given(budgets, lams, waits)
@settings(deadline=None)
def test_joint_reduces_to_algorithm1_at_n1(rem, lam, wait):
    """n_set=(1,) degenerates to the paper's single-replica Algorithm 1
    decision for decision — the joint solver is a strict extension."""
    d1 = solve_bruteforce(rem, lam, PERF, initial_wait=wait)
    d2 = solve_joint_bruteforce(rem, lam, PERF, n_set=(1,),
                                initial_wait=wait)
    assert (d1.c, d1.b, d1.feasible) == (d2.c, d2.b, d2.feasible)
    assert d2.n == 1


def test_joint_solver_fuzz_without_hypothesis():
    """Seeded fuzz of bruteforce == table == memo (+ the only_n pin and
    the core cap), each equal to the reference's decision, kept
    independent of hypothesis availability."""
    tab = JointSolverTable(PERF, n_set=N_SET)
    memo = JointMemoizedSolver(PERF, n_set=N_SET)
    jtab = jsolver.JointSolverTable(JPERF, n_set=N_SET)
    rng = np.random.default_rng(0)
    for k in range(150):
        n = int(rng.integers(0, 40))
        rem = np.sort(rng.uniform(0.0, 3.0, n))
        lam = float(rng.uniform(0, 300))
        iw = float(rng.uniform(0, 0.5))
        d1 = solve_joint_bruteforce(rem, lam, PERF, n_set=N_SET,
                                    initial_wait=iw)
        d2 = tab.solve(rem, lam, initial_wait=iw)
        d3 = memo.solve(rem, lam, initial_wait=iw)
        key = (d1.c, d1.b, d1.n, d1.feasible)
        assert key == (d2.c, d2.b, d2.n, d2.feasible)
        assert key == (d3.c, d3.b, d3.n, d3.feasible)
        assert _dkey(d2) == _dkey(jtab.solve(rem, lam, initial_wait=iw))
        dp = tab.solve(rem, lam, initial_wait=iw, only_n=4)
        db = solve_joint_bruteforce(rem, lam, PERF, n_set=(4,),
                                    initial_wait=iw)
        assert (dp.c, dp.b, dp.n, dp.feasible) == (db.c, db.b, db.n,
                                                   db.feasible)
        if k % 3:
            continue
        cap = int(rng.integers(1, 64))
        dc = tab.solve(rem, lam, initial_wait=iw, max_cores=cap)
        assert _dkey(dc) == _dkey(jtab.solve(rem, lam, initial_wait=iw,
                                             max_cores=cap))
        assert tab.min_violations(rem, lam, iw, max_cores=cap) == \
            jtab.min_violations(rem, lam, iw, max_cores=cap)
        if k % 9 == 0:          # the loop-and-count oracle is slow
            assert tab.min_violations(rem, lam, iw, max_cores=cap,
                                      sustaining_pool=False) == \
                jsolver._joint_min_violations_bruteforce(
                    rem, lam, JPERF, DEFAULT_C, DEFAULT_B, N_SET, iw,
                    max_cores=cap, sustaining_pool=False)
    assert tab.max_rate() == jtab.max_rate()
    assert tab.max_rate(max_cores=24) == jtab.max_rate(max_cores=24)


def test_joint_candidate_order_minimizes_total_cores():
    """The search order is total allocation ascending, so any feasible
    answer is the cheapest one; the replica penalty reorders wide fleets
    behind tall ones at equal cores."""
    cands = joint_candidates((1, 2, 4), (1, 2), (1, 2, 4))
    assert cands == jsolver.joint_candidates((1, 2, 4), (1, 2), (1, 2, 4))
    totals = [t for t, _, _, _ in cands]
    assert totals == sorted(totals)
    # pure objective: 4 replicas x 1 core ties 1 replica x 4 cores; the
    # tie breaks toward fewer replicas
    t4 = [(n, c) for t, n, b, c in cands if t == 4]
    assert t4[0][0] == 1
    pen = joint_candidates((1, 2, 4), (1,), (1, 2, 4), replica_pen=0.5)
    keys = [t for t, _, _, _ in pen]
    assert keys == sorted(keys)
    assert pen[0][1:] == (1, 1, 1)      # n=1, b=1, c=1 still first


def test_joint_solver_prefers_fewer_replicas_on_cost_ties():
    """With an empty queue and tiny λ the cheapest allocation is one
    1-core replica — never a wide fleet of the same total size."""
    d = solve_joint_bruteforce([], 0.5, PERF, n_set=N_SET)
    assert (d.n, d.c) == (1, 1) and d.feasible


def test_joint_solver_scales_out_when_vertical_saturates():
    """A λ beyond one replica's max throughput forces n > 1."""
    lam_max = float(max(PERF.throughput(b, max(DEFAULT_C))
                        for b in DEFAULT_B))
    d = solve_joint_bruteforce([], lam_max * 2.5, PERF, n_set=N_SET)
    assert d.feasible and d.n > 1
    assert d.n * float(PERF.throughput(d.b, d.c)) >= lam_max * 2.5


# --------------------------------------------------------------------------
# hysteresis + scale-down drain semantics
# --------------------------------------------------------------------------
def test_hysteresis_blocks_transient_scale_down():
    """A lower-n target must persist ``down_patience`` decisions before
    the fleet shrinks; in the meantime (c, b) re-solves at the pinned n."""
    sc = FleetSpongeScaler(PERF, down_patience=3, scale_up_delay=0.0)
    rem = np.empty(0)
    # active fleet of 8; the solver wants 1 replica at this load
    for i in range(2):
        d = sc.decide_fleet(float(i), rem, 2.0, active_n=8)
        assert d.n == 8, "scale-down emitted before patience ran out"
    d = sc.decide_fleet(2.0, rem, 2.0, active_n=8)
    assert d.n < 8, "scale-down never emitted"
    # an up-target resets the streak
    sc2 = FleetSpongeScaler(PERF, down_patience=2, scale_up_delay=0.0)
    sc2.decide_fleet(0.0, rem, 2.0, active_n=8)
    lam_big = 2.5 * float(max(PERF.throughput(b, max(DEFAULT_C))
                              for b in DEFAULT_B))
    d_up = sc2.decide_fleet(1.0, rem, lam_big, active_n=1)
    assert d_up.n > 1
    assert sc2._down_streak == 0


def test_hysteresis_pin_survives_sparse_n_set():
    """After a kill event active_n can sit outside a sparse n_set; the
    blocked-scale-down re-solve must pin to a *valid* entry (rounding
    down — conservative) and still hold the actual fleet size."""
    sc = FleetSpongeScaler(PERF, n_set=(1, 2, 4, 8, 16), down_patience=3,
                           scale_up_delay=0.0)
    d = sc.decide_fleet(0.0, np.empty(0), 2.0, active_n=7)
    assert d.n == 7, "fleet size not held during hysteresis"
    assert d.feasible, "pinned re-solve fell into the infeasible fallback"
    assert d.c < max(DEFAULT_C), "light load must not pin max capacity"
    jsc = jfleet.FleetSpongeScaler(JPERF, n_set=(1, 2, 4, 8, 16),
                                   down_patience=3, scale_up_delay=0.0)
    jd = jsc.decide_fleet(0.0, np.empty(0), 2.0, active_n=7)
    assert _dkey(d) == _dkey(jd)


def test_scale_down_drains_before_releasing_cores():
    """A retiring replica stops admitting, finishes in-flight work, and
    releases cores at max(now, busy_until); its queue re-routes."""
    runner = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B,
                                n0=4, c0=8, prior_rps=10)
    victim = runner.replicas[-1]
    victim.busy_until = 12.5
    victim.queue.push(20.0, 0)
    victim.queue.push(21.0, 1)
    runner._apply(Decision(c=8, b=4, n=2), now=10.0)
    assert len(runner.replicas) == 2
    assert victim in runner.dead
    assert victim.dead_at == 12.5          # finishes in-flight work first
    assert len(victim.queue._heap) == 0    # queue re-routed
    moved = sum(len(r.queue._heap) for r in runner.replicas)
    assert moved == 2
    victim.account(100.0)                  # report clamps to dead_at
    assert victim._last_t >= min(victim.dead_at, 100.0)


def test_fleet_never_scales_to_zero():
    runner = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B,
                                n0=2, c0=8)
    runner._apply(Decision(c=8, b=1, n=0), now=0.0)
    assert len(runner.replicas) == 1
    runner._fleet_event("kill", (0,), 1.0)
    assert len(runner.replicas) == 1, "the last replica must survive kills"


def test_restart_event_spawns_cold_replacement():
    runner = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B,
                                n0=3, c0=8)
    old = runner.replicas[0]
    runner._fleet_event("restart", (0, 4.0), 10.0)
    assert len(runner.replicas) == 3
    assert old in runner.dead
    fresh = runner.replicas[-1]
    assert fresh.ready_at == 14.0 and fresh.c == old.c


# --------------------------------------------------------------------------
# routers
# --------------------------------------------------------------------------
def _push(rep, deadline, idx):
    """Push the way the runners do: heap + sorted deadline mirror."""
    rep.queue.push(deadline, idx)
    insort(rep.dls, deadline)


def test_routers_balance_and_respect_cold_starts():
    runner = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B,
                                n0=3, c0=8)
    a, b, c = runner.replicas
    _push(a, 5.0, 0)
    _push(a, 6.0, 1)
    _push(b, 5.5, 2)
    assert route_request("jsq", runner.replicas, 7.0, 0.0) == 2
    _push(c, 5.9, 3)
    b.busy_until = 1.0
    assert route_request("least-loaded", runner.replicas, 7.0, 0.0) == 2
    assert route_request("edf-deadline", runner.replicas, 5.2, 0.0) == 1
    cold = runner._cold_load(0.0)
    c.ready_at = 10.0
    assert route_request("least-loaded", runner.replicas, 7.0, 0.0,
                         cold_load=cold) == 0
    assert cold(c) > 10.0 and cold(a) == 0.0
    # the reference's router picks the same replicas on the same fleet
    for router in ROUTERS:
        for dl in (4.0, 5.2, 5.95, 7.0):
            assert route_request(router, runner.replicas, dl, 0.0,
                                 cold_load=cold) == \
                jfleet.route_request(router, runner.replicas, dl, 0.0,
                                     cold_load=cold)
    with pytest.raises(KeyError):
        route_request("no-such-router", runner.replicas, 1.0, 0.0)


def test_deadline_mirror_tracks_queues_mid_backlog():
    """The sorted deadline mirror the edf-deadline router bisects must
    equal the live heap contents at any stop point — checked by cutting
    a fleet-flash-crowd run mid-spike, when queues hold real backlog."""
    batch, meta = build_scenario("fleet-flash-crowd", duration=120, seed=3)
    runner = FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B,
                                n0=meta["n0"], c0=meta["c0"],
                                tick=meta["tick"],
                                prior_rps=meta["expected_rps"],
                                router="edf-deadline")
    runner.run(batch, horizon=0.42 * 120)      # inside the first spike
    backlog = 0
    for r in runner.replicas:
        heap_dls = sorted(item[0] for item in r.queue._heap)
        assert r.dls == heap_dls
        backlog += len(heap_dls)
    assert backlog > 0, "expected queued work mid-spike"


def test_unknown_router_and_policy_rejected():
    with pytest.raises(KeyError):
        FleetFastSimRunner(_scaler(), PERF, DEFAULT_C, DEFAULT_B,
                           router="bogus")

    class NotAFleetPolicy:
        pass

    with pytest.raises(TypeError):
        FleetFastSimRunner(NotAFleetPolicy(), PERF, DEFAULT_C, DEFAULT_B)
    with pytest.raises(ValueError, match="fleet scenarios run"):
        run_scenario("replica-failure", policy="fa2", duration=10)


# --------------------------------------------------------------------------
# end-to-end economics
# --------------------------------------------------------------------------
def test_fleet_saves_cores_vs_static_at_no_worse_violations():
    """The joint scaler beats the peak-provisioned static fleet on
    core-seconds without losing on violation rate, as in the
    reference."""
    sponge, stats = run_scenario("replica-failure", engine="fast",
                                 duration=150, seed=7)
    static, _ = run_scenario("replica-failure", engine="fast",
                             policy="static-16", duration=150, seed=7)
    assert sponge.violation_rate <= static.violation_rate + 0.01
    assert sponge.core_seconds < 0.8 * static.core_seconds
    assert stats["max_replicas"] >= 4
    jsponge, _ = jax_scenarios.run_scenario("replica-failure",
                                            engine="fast", duration=150,
                                            seed=7)
    assert _sig(sponge) == _sig(jsponge)


def test_fleet_scenarios_registered_and_routed():
    from repro_torch.serving.scenarios import SCENARIOS
    for name in FLEET_SCENARIOS:
        assert name in SCENARIOS
        batch, meta = build_scenario(name, duration=60, seed=1)
        jbatch, jmeta = jax_scenarios.build_scenario(name, duration=60,
                                                     seed=1)
        assert meta["fleet"] is True and len(batch) > 0
        assert meta["n0"] >= 4 and meta["router"] in ROUTERS
        np.testing.assert_array_equal(batch.deadline, jbatch.deadline)
        np.testing.assert_array_equal(batch.arrival, jbatch.arrival)
        assert meta["fleet_events"] == jmeta["fleet_events"]
        assert (meta["n0"], meta["c0"], meta["router"], meta["tick"]) == \
            (jmeta["n0"], jmeta["c0"], jmeta["router"], jmeta["tick"])
