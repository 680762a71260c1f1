"""The port's model ladder and (m, n, c, b) solvers against the JAX
package's.

``core/degradation.py``, the (m, n, c, b) solvers of ``core/solver.py``
and ``DegradingFleetScaler`` are NumPy copies of the reference's, so the
ladder, solver and scaler cases of ``tests/test_degradation.py`` run
here on the port (the pinned-m reduction, the monotone shed, the swap
hysteresis), and the same inputs through both packages must give the
same ladders (rung names, accuracies, swap costs, fitted cost
parameters) and solver decisions, with no float tolerance.  The runner
and scenario half is ``tests/test_torch_degradation_fleet.py``.
Everything here runs on the CPU.
"""
import dataclasses

import numpy as np
import pytest
from _hyp import given, settings, st  # guarded hypothesis import

from repro.core import degradation as jdeg
from repro.core import solver as jsolver
from repro_torch.configs import registry
from repro_torch.core.degradation import (DEFAULT_LADDER_ARCHS,
                                          FULL_LADDER_ARCHS, ModelLadder,
                                          ModelRung, default_ladder,
                                          fit_rung_cost, resolve_ladder)
from repro_torch.core.monitor import accuracy_weighted_goodput
from repro_torch.core.perf_model import PerfModel, yolov5s_like
from repro_torch.core.slo import Decision
from repro_torch.core.solver import (JointSolverTable,
                                     MultiModelMemoizedSolver,
                                     MultiModelSolverTable,
                                     solve_joint_bruteforce,
                                     solve_multimodel_bruteforce)
from repro_torch.serving.fleet import DegradingFleetScaler

PERF = yolov5s_like()
N_SET = (1, 2, 4, 8, 16)
LADDER = default_ladder()
JLADDER = jdeg.default_ladder()


def _slowed(s: float) -> PerfModel:
    return PerfModel(gamma=PERF.gamma * s, eps=PERF.eps * s,
                     delta=PERF.delta * s, eta=PERF.eta * s)


def _two_rung_ladder(swap_big: float = 0.5, swap_small: float = 0.1
                     ) -> ModelLadder:
    """A synthetic big/small ladder with an 8x latency gap."""
    return ModelLadder([
        ModelRung("big", 0.9, _slowed(8.0), swap_cost=swap_big),
        ModelRung("small", 0.6, PERF, swap_cost=swap_small)])


def _rungs(ladder):
    """Every number a ladder carries: name, accuracy, swap cost and the
    fitted cost surface's parameters (``r2`` included)."""
    return [(r.name, r.accuracy, r.swap_cost,
             tuple(getattr(r.cost, f.name)
                   for f in dataclasses.fields(r.cost)))
            for r in ladder]


def _decision_key(d: Decision):
    return (d.c, d.b, d.n, d.feasible, d.solver_iters)


# --------------------------------------------------------------------------
# ladder construction + resolution
# --------------------------------------------------------------------------
def test_ladder_validates_and_orders():
    lad = _two_rung_ladder()
    assert [r.name for r in lad] == ["big", "small"]  # accuracy-descending
    assert lad.accuracy("big") == 0.9 and lad.swap_cost("small") == 0.1
    assert "big" in lad and "nope" not in lad and len(lad) == 2
    with pytest.raises(KeyError):
        lad.rung("nope")
    with pytest.raises(ValueError):
        ModelLadder([])
    with pytest.raises(ValueError):                       # duplicate name
        ModelLadder([ModelRung("a", 0.9, PERF), ModelRung("a", 0.5, PERF)])
    with pytest.raises(ValueError):                       # duplicate accuracy
        ModelLadder([ModelRung("a", 0.9, PERF), ModelRung("b", 0.9, PERF)])
    with pytest.raises(ValueError):                       # accuracy range
        ModelLadder([ModelRung("a", 1.5, PERF)])


def test_ladder_floor_and_pins():
    lad = _two_rung_ladder()
    assert lad.best().name == "big"
    with pytest.raises(ValueError):
        lad.best(0.95)                    # floor above every rung
    assert [r.name for r in lad.admissible(0.7)] == ["big"]
    assert [r.name for r in lad.admissible(0.0, m_set=("small",))] == \
        ["small"]
    with pytest.raises(ValueError):
        lad.admissible(0.7, m_set=("small",))   # pin below the floor


@pytest.mark.parametrize("spec", ["default", "full", "smollm-135m, gemma-2b",
                                  ("smollm-135m", "smollm-360m")])
def test_resolve_ladder_specs(spec):
    """Every spec form resolves to the reference's ladder: the same rung
    names in the same order, accuracies, swap costs and fitted cost
    parameters, float for float."""
    lad, jlad = resolve_ladder(spec), jdeg.resolve_ladder(spec)
    assert _rungs(lad) == _rungs(jlad)
    if spec == "full":
        assert {r.name for r in lad} == set(FULL_LADDER_ARCHS)
    assert resolve_ladder(None) is None
    assert resolve_ladder(LADDER) is LADDER


def test_default_ladder_is_deterministic_and_swap_scaled():
    a, b = default_ladder(), default_ladder()
    for ra, rb in zip(a, b):
        assert ra.name == rb.name and ra.swap_cost == rb.swap_cost
        assert ra.cost.latency(4, 8) == rb.cost.latency(4, 8)
    assert a.swap_cost("gemma-2b") > a.swap_cost("smollm-135m") > 0.0
    assert a.cost("gemma-2b").latency(1, 16) > \
        a.cost("smollm-135m").latency(1, 16)
    assert _rungs(a) == _rungs(JLADDER)
    assert {r.name for r in a} == set(DEFAULT_LADDER_ARCHS)


def test_fit_rung_cost_and_accuracy_table_equal_reference():
    from repro.configs import registry as jregistry
    for scale, seed in ((1.0, 0), (1.7, 3), (2.4, 1001)):
        fit = fit_rung_cost(PERF, scale, seed=seed)
        jfit = jdeg.fit_rung_cost(jdeg.yolov5s_like(), scale, seed=seed)
        assert dataclasses.asdict(fit) == dataclasses.asdict(jfit)
    assert registry.MODEL_ACCURACY == jregistry.MODEL_ACCURACY
    assert set(registry.ARCH_IDS) == set(jregistry.ARCH_IDS)
    for arch in registry.ARCH_IDS:
        assert registry.model_accuracy(arch + "-reduced") == \
            jregistry.model_accuracy(arch)
        cfg, jcfg = (registry.get_config(arch),
                     jregistry.get_config(arch))
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.param_count() == jcfg.param_count()
    with pytest.raises(KeyError):
        registry.model_accuracy("no-such-arch")


# --------------------------------------------------------------------------
# the pinned-m reduction: bit-identity with the joint solver
# --------------------------------------------------------------------------
def test_pinned_m_reduces_to_joint_solver():
    """m_set=(rung,) + current_m=rung is a pure delegation: every field
    of the joint decision survives, solver_iters included."""
    mm = MultiModelSolverTable(LADDER, n_set=N_SET)
    rng = np.random.default_rng(0)
    for trial in range(40):
        rung = LADDER[trial % len(LADDER)]
        joint = JointSolverTable(rung.cost, n_set=N_SET)
        n = int(rng.integers(0, 30))
        rem = np.sort(rng.uniform(0.0, 2.5, n))
        lam = float(rng.uniform(0, 300))
        iw = float(rng.uniform(0, 0.4))
        d1 = joint.solve(rem, lam, initial_wait=iw)
        d2 = mm.solve(rem, lam, initial_wait=iw,
                      m_set=(rung.name,), current_m=rung.name)
        assert _decision_key(d1) == _decision_key(d2), (trial, rung.name)
        assert d2.m == rung.name
        d3 = mm.solve(rem, lam, initial_wait=iw, m_set=(rung.name,),
                      current_m=rung.name,
                      accuracy_floor=rung.accuracy - 1e-9)
        assert _decision_key(d1) == _decision_key(d3)


def test_table_matches_bruteforce():
    """MultiModelSolverTable == solve_multimodel_bruteforce, fallback
    ordering included, across floors / pins / resident models — and
    both equal the reference's table on the reference's ladder."""
    mm = MultiModelSolverTable(LADDER, n_set=N_SET)
    jmm = jsolver.MultiModelSolverTable(JLADDER, n_set=N_SET)
    names = [r.name for r in LADDER]
    rng = np.random.default_rng(1)
    for trial in range(60):
        n = int(rng.integers(0, 25))
        rem = np.sort(rng.uniform(0.0, 2.0, n))
        lam = float(rng.uniform(0, 400))
        iw = float(rng.uniform(0, 0.3))
        floor = float(rng.choice([0.0, 0.6, 0.65]))
        cur = names[int(rng.integers(0, len(names)))] \
            if rng.random() < 0.7 else None
        d1 = solve_multimodel_bruteforce(rem, lam, LADDER, n_set=N_SET,
                                         initial_wait=iw,
                                         accuracy_floor=floor,
                                         current_m=cur)
        d2 = mm.solve(rem, lam, initial_wait=iw, accuracy_floor=floor,
                      current_m=cur)
        j2 = jmm.solve(rem, lam, initial_wait=iw, accuracy_floor=floor,
                       current_m=cur)
        assert (d1.m, d1.c, d1.b, d1.n, d1.feasible) == \
            (d2.m, d2.c, d2.b, d2.n, d2.feasible), trial
        assert (d2.m,) + _decision_key(d2) == (j2.m,) + _decision_key(j2)


def test_memoized_matches_table_and_caches():
    memo = MultiModelMemoizedSolver(LADDER, n_set=N_SET)
    jmemo = jsolver.MultiModelMemoizedSolver(JLADDER, n_set=N_SET)
    rem = np.array([0.5, 0.8, 1.2])
    d1 = memo.solve(rem, 40.0, accuracy_floor=0.6, current_m="gemma-2b")
    d2 = memo.solve(rem, 40.0, accuracy_floor=0.6, current_m="gemma-2b")
    assert (d1.m, d1.c, d1.b, d1.n) == (d2.m, d2.c, d2.b, d2.n)
    assert memo.hits >= 1
    d3 = memo.solve(rem, 40.0, accuracy_floor=0.6,
                    current_m="smollm-360m")
    assert d3.m is not None
    for cur, d in (("gemma-2b", d1), ("smollm-360m", d3)):
        j = jmemo.solve(rem, 40.0, accuracy_floor=0.6, current_m=cur)
        assert (d.m,) + _decision_key(d) == (j.m,) + _decision_key(j)


# --------------------------------------------------------------------------
# monotone shed + the accuracy floor
# --------------------------------------------------------------------------
@given(st.lists(st.floats(0.05, 2.0), min_size=0, max_size=25),
       st.floats(0.0, 400.0), st.floats(0.0, 0.3))
@settings(deadline=None, max_examples=40)
def test_feasible_decision_sheds_monotonically(rem, lam, iw):
    """The chosen rung of a *feasible* decision is the highest-accuracy
    admissible rung with any feasible (n, c, b): every strictly more
    accurate rung is infeasible under its own joint solve."""
    rem = sorted(rem)
    d = solve_multimodel_bruteforce(rem, lam, LADDER, n_set=N_SET,
                                    initial_wait=iw, accuracy_floor=0.6)
    if not d.feasible:
        return
    acc = LADDER.accuracy(d.m)
    assert acc >= 0.6 - 1e-12           # the floor fences the shed
    for rung in LADDER.admissible(0.6):
        dj = solve_joint_bruteforce(rem, lam, rung.cost, n_set=N_SET,
                                    initial_wait=iw)
        if rung.accuracy > acc:
            assert not dj.feasible, (rung.name, d.m)
        elif rung.name == d.m:
            assert dj.feasible


def test_feasible_decision_sheds_monotonically_seeded():
    """Deterministic fuzz twin of the hypothesis property above."""
    rng = np.random.default_rng(9)
    checked = 0
    for _ in range(60):
        rem = np.sort(rng.uniform(0.05, 2.0, int(rng.integers(0, 25))))
        lam = float(rng.uniform(0, 200))
        iw = float(rng.uniform(0, 0.3))
        d = solve_multimodel_bruteforce(rem, lam, LADDER, n_set=N_SET,
                                        initial_wait=iw,
                                        accuracy_floor=0.6)
        if not d.feasible:
            continue
        checked += 1
        acc = LADDER.accuracy(d.m)
        assert acc >= 0.6 - 1e-12
        for rung in LADDER.admissible(0.6):
            if rung.accuracy > acc:
                dj = solve_joint_bruteforce(rem, lam, rung.cost,
                                            n_set=N_SET, initial_wait=iw)
                assert not dj.feasible, (rung.name, d.m)
    assert checked >= 10          # the fuzz actually hit feasible cases


def test_relaxed_budgets_never_shed():
    d = solve_multimodel_bruteforce([5.0, 6.0], 2.0, LADDER, n_set=N_SET)
    assert d.feasible and d.m == LADDER[0].name


def test_floor_above_ladder_raises():
    with pytest.raises(ValueError):
        solve_multimodel_bruteforce([], 1.0, LADDER, n_set=N_SET,
                                    accuracy_floor=0.99)


def test_swap_cost_gates_non_resident_rungs():
    """A lower rung that is feasible only without its weights-load time
    is not a legal shed target while non-resident."""
    lad = _two_rung_ladder(swap_big=0.5, swap_small=10.0)
    small_lat = float(PERF.latency(1, 16))
    big_lat = float(lad.cost("big").latency(1, 16))
    budget = (small_lat + big_lat) / 2.0      # small fits, big does not
    rem = np.full(3, budget)
    d_res = solve_multimodel_bruteforce(rem, 1.0, lad, n_set=N_SET,
                                        current_m="small")
    assert d_res.feasible and d_res.m == "small"
    d_swap = solve_multimodel_bruteforce(rem, 1.0, lad, n_set=N_SET,
                                         current_m="big")
    assert not d_swap.feasible


def test_all_infeasible_fallback_prefers_sustaining_rung():
    """Dead backlog, λ above the top rung's ceiling: the
    capacity-accuracy product hands the fallback to a rung that absorbs
    λ; at low λ raw accuracy decides again."""
    mm = MultiModelSolverTable(LADDER, n_set=N_SET)
    tops = {r.name: mm.tables[r.name].max_rate(None) for r in LADDER}
    rem = np.zeros(40)                       # every deadline already blown
    lam_mid = (tops["gemma-2b"] + tops["smollm-360m"]) / 2.0
    d = mm.solve(rem, lam_mid, accuracy_floor=0.6)
    assert not d.feasible
    assert tops[d.m] >= lam_mid, (d.m, tops)
    assert d.m != "gemma-2b"
    d_low = mm.solve(rem, min(tops.values()) * 0.5, accuracy_floor=0.6)
    assert d_low.m == "gemma-2b"
    jmm = jsolver.MultiModelSolverTable(JLADDER, n_set=N_SET)
    for lam in (lam_mid, min(tops.values()) * 0.5):
        db = solve_multimodel_bruteforce(rem, lam, LADDER, n_set=N_SET,
                                         accuracy_floor=0.6)
        dt = mm.solve(rem, lam, accuracy_floor=0.6)
        assert db.m == dt.m == jmm.solve(rem, lam, accuracy_floor=0.6).m


# --------------------------------------------------------------------------
# accuracy-weighted goodput
# --------------------------------------------------------------------------
def test_accuracy_weighted_goodput_unit():
    from repro.core.monitor import accuracy_weighted_goodput as jagp
    log = [(0.0, "big", 0.9), (5.0, "small", 0.6)]
    finish = np.array([1.0, 6.0, 8.0, np.nan])
    deadline = np.array([2.0, 7.0, 7.5, 9.0])   # third one is late
    agp, macc = accuracy_weighted_goodput(finish, deadline, log, 10.0)
    assert agp == pytest.approx((0.9 + 0.6) / 10.0)
    assert macc == pytest.approx((0.9 + 0.6 + 0.6) / 3.0)
    assert (agp, macc) == jagp(finish, deadline, log, 10.0)
    agp0, macc0 = accuracy_weighted_goodput(
        np.array([np.nan]), np.array([1.0]), log, 10.0)
    assert agp0 == 0.0 and np.isnan(macc0)


# --------------------------------------------------------------------------
# scaler: asymmetric swap hysteresis
# --------------------------------------------------------------------------
def test_shed_commits_fast_recovery_commits_slow():
    lad = _two_rung_ladder()
    sc = DegradingFleetScaler(PERF, ladder=lad, adaptation_interval=1.0,
                              shed_patience=2, swap_patience=3,
                              scale_up_delay=0.0)
    assert sc.model == "big"
    overload = np.full(6, 0.4)      # big (~0.6 s single-item) cannot fit
    calm = np.empty(0)
    d = sc.decide_fleet(0.0, overload, 5.0, active_n=1)
    assert sc.model == "big" and d.m == "big"     # held: streak 1 < 2
    d = sc.decide_fleet(1.0, overload, 5.0, active_n=1)
    assert sc.model == "small" and d.m == "small"  # shed committed
    d = sc.decide_fleet(2.0, calm, 5.0, active_n=1)
    assert sc.model == "small" and d.m == "small"
    d = sc.decide_fleet(3.0, calm, 5.0, active_n=1)
    assert sc.model == "small"
    d = sc.decide_fleet(4.0, calm, 5.0, active_n=1)
    assert sc.model == "big" and d.m == "big"      # recovery committed


def test_resident_proposal_resets_swap_streak():
    lad = _two_rung_ladder()
    sc = DegradingFleetScaler(PERF, ladder=lad, adaptation_interval=1.0,
                              shed_patience=2, swap_patience=3,
                              scale_up_delay=0.0)
    sc.decide_fleet(0.0, np.full(6, 0.4), 5.0, active_n=1)
    sc.decide_fleet(1.0, np.full(6, 0.4), 5.0, active_n=1)
    assert sc.model == "small"
    sc.decide_fleet(2.0, np.empty(0), 5.0, active_n=1)   # big, streak 1
    sc.decide_fleet(3.0, np.full(6, 0.4), 5.0, active_n=1)  # resident wins
    assert sc._swap_streak == 0 and sc.model == "small"
    sc.decide_fleet(4.0, np.empty(0), 5.0, active_n=1)   # streak restarts
    sc.decide_fleet(5.0, np.empty(0), 5.0, active_n=1)
    assert sc.model == "small"                           # 2 < 3: still held
    sc.decide_fleet(6.0, np.empty(0), 5.0, active_n=1)
    assert sc.model == "big"


def test_scaler_requires_ladder_and_validates_m0():
    with pytest.raises(ValueError):
        DegradingFleetScaler(PERF)
    with pytest.raises(KeyError):
        DegradingFleetScaler(PERF, ladder=_two_rung_ladder(), m0="nope")
    sc = DegradingFleetScaler(PERF, ladder=_two_rung_ladder(),
                              accuracy_floor=0.7)
    assert sc.model == "big"        # best rung above the floor
