"""The port's model-ladder fleets against the JAX package's.

The runner half of ``tests/test_degradation.py`` on the port: the
weights-load penalty delays dispatch but never core-seconds, in both
fleet engines; the fast engine equals the exact gang loop with model
swaps on every ``degrade-*`` scenario; and ``run_scenario`` on them
gives the reference's run (decisions, buckets, accuracy-weighted
goodput, the resident-model timeline, ladder, solver statistics and
event count), with no float tolerance.  The ladder and solver half is
``tests/test_torch_degradation.py``.  Everything here runs on the CPU.
"""
import numpy as np
import pytest

from repro.serving import scenarios as jax_scenarios
from repro_torch.core.degradation import (DEFAULT_LADDER_ARCHS, ModelLadder,
                                          ModelRung, resolve_ladder)
from repro_torch.core.perf_model import PerfModel, yolov5s_like
from repro_torch.core.slo import Decision
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.serving.fleet import (DegradingFleetScaler,
                                       FleetExactRunner, FleetFastSimRunner)
from repro_torch.serving.scenarios import (SCENARIOS, build_scenario,
                                           run_scenario)

PERF = yolov5s_like()
DEGRADE_SCENARIOS = ("degrade-sustained-overload", "degrade-flash-overload",
                     "degrade-fade-overload")


def _slowed(s: float) -> PerfModel:
    return PerfModel(gamma=PERF.gamma * s, eps=PERF.eps * s,
                     delta=PERF.delta * s, eta=PERF.eta * s)


def _two_rung_ladder(swap_big: float = 0.5, swap_small: float = 0.1
                     ) -> ModelLadder:
    """A synthetic big/small ladder with an 8x latency gap."""
    return ModelLadder([
        ModelRung("big", 0.9, _slowed(8.0), swap_cost=swap_big),
        ModelRung("small", 0.6, PERF, swap_cost=swap_small)])


# --------------------------------------------------------------------------
# runners: drain-before-swap + core-second accounting (both engines)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cls", (FleetFastSimRunner, FleetExactRunner))
def test_swap_penalty_delays_dispatch_not_core_seconds(cls):
    lad = _two_rung_ladder()

    def mk():
        sc = DegradingFleetScaler(PERF, ladder=lad,
                                  adaptation_interval=1.0)
        return cls(sc, PERF, DEFAULT_C, DEFAULT_B, n0=2, c0=8,
                   ladder=lad, m0="big")

    runner = mk()
    twin = mk()
    inflight = runner.replicas[0]
    inflight.busy_until = 12.5                 # old-model batch in flight
    runner._apply(Decision(c=8, b=2, n=2, m="small"), now=10.0)
    assert inflight.busy_until == pytest.approx(12.5 + 0.1)
    assert runner.replicas[1].busy_until == pytest.approx(10.0 + 0.1)
    assert runner.model == "small"
    assert runner._lat == runner._lat_by_m["small"]
    assert runner.model_log == [(0.0, "big", 0.9), (10.0, "small", 0.6)]
    twin.replicas[0].busy_until = 12.5
    twin._apply(Decision(c=8, b=2, n=2, m="big"), now=10.0)
    for r_sw, r_ns in zip(runner.replicas, twin.replicas):
        r_sw.account(50.0)
        r_ns.account(50.0)
        assert r_sw.core_seconds == pytest.approx(r_ns.core_seconds)
    assert twin.model_log == [(0.0, "big", 0.9)]   # no swap logged


@pytest.mark.parametrize("cls", (FleetFastSimRunner, FleetExactRunner))
def test_ladder_runner_validates_m0_and_cold_lat(cls):
    lad = _two_rung_ladder()
    sc = DegradingFleetScaler(PERF, ladder=lad, adaptation_interval=1.0)
    with pytest.raises(KeyError):
        cls(sc, PERF, DEFAULT_C, DEFAULT_B, n0=1, c0=8,
            ladder=lad, m0="nope")
    r = cls(sc, PERF, DEFAULT_C, DEFAULT_B, n0=1, c0=8, ladder=lad)
    assert r.model == "big"                    # policy's resident rung
    assert r._lat[(8, 2)] == pytest.approx(
        float(lad.cost("big").latency(2, 8)))


# --------------------------------------------------------------------------
# engine identity under model swaps, and the reference's runs
# --------------------------------------------------------------------------
def _f(x):
    return "nan" if isinstance(x, float) and np.isnan(x) else x


def _sig(rep):
    decs = [(t, d.c, d.b, d.n, d.m, d.scale_up_delay, d.feasible)
            for t, d in (rep.decisions or [])]
    return (decs, rep.buckets, rep.n_requests, rep.n_violations,
            rep.core_seconds, _f(rep.p50), _f(rep.p99), rep.core_timeline,
            _f(rep.accuracy_goodput), _f(rep.mean_served_accuracy),
            rep.model_swaps, rep.model_timeline)


@pytest.mark.parametrize("name", DEGRADE_SCENARIOS)
def test_degrade_engine_identity_with_swaps(name):
    """Fast engine == exact gang loop on the degrade scenarios — model
    swaps, drain penalties, accuracy metrics and all.  (The reference's
    runs are held to the port's in the ``run_scenario`` tests below.)"""
    batch, meta = build_scenario(name, duration=60, seed=3)
    ladder = resolve_ladder(meta["ladder"])

    def mk():
        return DegradingFleetScaler(
            PERF, adaptation_interval=meta["tick"],
            budget_quantum=0.01, lam_quantum=0.5, ladder=ladder,
            accuracy_floor=meta["accuracy_floor"])

    kw = dict(n0=meta["n0"], c0=meta["c0"], tick=meta["tick"],
              prior_rps=meta["expected_rps"], router=meta["router"])
    p1, p2 = mk(), mk()
    fast = FleetFastSimRunner(p1, PERF, DEFAULT_C, DEFAULT_B,
                              ladder=ladder, m0=p1.model, **kw)
    exact = FleetExactRunner(p2, PERF, DEFAULT_C, DEFAULT_B,
                             ladder=ladder, m0=p2.model, **kw)
    got = _sig(fast.run(batch, events=meta["fleet_events"]))
    ref = _sig(exact.run(batch, events=meta["fleet_events"]))
    assert got == ref
    assert got[10] > 0, "scenario exercised no model swap"


@pytest.mark.parametrize("name,engine", [
    ("degrade-sustained-overload", "fast"),
    ("degrade-flash-overload", "exact"),
    ("degrade-fade-overload", "fast")])
def test_run_scenario_degrade_equals_reference(name, engine):
    """``run_scenario`` on a degrade scenario (the fast engine with its
    quanta, or the exact gang loop at quanta 0): the same report,
    ladder, floor, solver statistics and event count as the
    reference's."""
    rep, stats = run_scenario(name, engine=engine, duration=60, seed=4)
    jrep, jstats = jax_scenarios.run_scenario(name, engine=engine,
                                              duration=60, seed=4)
    assert _sig(rep) == _sig(jrep)
    for k in ("events", "max_replicas", "router", "solver", "ladder",
              "accuracy_floor"):
        assert stats[k] == jstats[k], k


# --------------------------------------------------------------------------
# scenarios + run_scenario plumbing
# --------------------------------------------------------------------------
def test_degrade_scenarios_registered():
    for name in DEGRADE_SCENARIOS:
        assert name in SCENARIOS
        batch, meta = build_scenario(name, duration=60, seed=1)
        jbatch, jmeta = jax_scenarios.build_scenario(name, duration=60,
                                                     seed=1)
        assert meta["fleet"] is True and len(batch) > 0
        assert meta["ladder"] == "default"
        assert meta["accuracy_floor"] == pytest.approx(0.60)
        np.testing.assert_array_equal(batch.deadline, jbatch.deadline)
        assert (meta["ladder"], meta["accuracy_floor"], meta["n0"]) == \
            (jmeta["ladder"], jmeta["accuracy_floor"], jmeta["n0"])


def test_run_scenario_rejects_ladder_on_non_fleet():
    with pytest.raises(ValueError, match="fleet scenarios only"):
        run_scenario("steady", duration=5, model_ladder="default")
    with pytest.raises(ValueError, match="fleet scenarios only"):
        run_scenario("steady", duration=5, accuracy_floor=0.6)


def test_run_scenario_degradation_reporting():
    rep, stats = run_scenario("degrade-flash-overload", duration=45,
                              seed=3)
    assert set(stats["ladder"]) == set(DEFAULT_LADDER_ARCHS)
    assert stats["accuracy_floor"] == pytest.approx(0.60)
    assert rep.accuracy_goodput > 0.0
    assert 0.0 < rep.mean_served_accuracy <= 1.0
    assert rep.model_timeline[0][0] == 0.0
    assert all(m != "smollm-135m" for _, m, _ in rep.model_timeline)


def test_fixed_rung_policy_reports_accuracy():
    rep, stats = run_scenario("degrade-flash-overload", duration=45,
                              seed=3, policy="fixed-smollm-360m")
    jrep, _ = jax_scenarios.run_scenario("degrade-flash-overload",
                                         duration=45, seed=3,
                                         policy="fixed-smollm-360m")
    assert rep.policy == "fixed-smollm-360m"
    assert rep.model_swaps == 0
    assert rep.mean_served_accuracy == pytest.approx(0.64)
    assert stats["ladder"] == ["smollm-360m"]
    assert _sig(rep) == _sig(jrep)
    with pytest.raises(KeyError):
        run_scenario("degrade-flash-overload", duration=5,
                     policy="fixed-no-such-arch")


def test_full_ladder_on_a_fleet_scenario_equals_reference():
    """``model_ladder="full"`` on a plain fleet scenario prices the MoE
    configs through ``active_param_count``; the run is the
    reference's."""
    kw = dict(duration=30, seed=2, model_ladder="full",
              accuracy_floor=0.7)
    rep, stats = run_scenario("fleet-flash-crowd", **kw)
    jrep, jstats = jax_scenarios.run_scenario("fleet-flash-crowd", **kw)
    assert _sig(rep) == _sig(jrep)
    assert stats["ladder"] == jstats["ladder"]
    assert "kimi-k2-1t-a32b" in stats["ladder"]
