"""The port's multi-tenant pool against the JAX package's.

``serving/tenancy.py`` and the ``mixed-zoo`` pair of
``serving/scenarios.py`` are NumPy copies of the reference's, so the
cases of ``tests/test_tenancy.py`` run here on the port (fast engine at
quanta 0 == the exact pre-heaped oracle on both scenarios x the three
pool policies; the reallocator's budget, floor, fair-share and
priority properties; overflow pricing; starvation reported), and the
same scenario through both packages must give the same pool decisions
(caps, swaps, the cap log), per-tenant decision streams, buckets and
report floats, on both engines, with no float tolerance.  The launcher's
``--tenants`` / ``--pool-cores`` print the pool's summary line.
Everything here runs on the CPU.
"""
import numpy as np
import pytest

from repro.serving import scenarios as jax_scenarios
from repro_torch.core.solver import JointSolverTable
from repro_torch.launch import serve as launcher
from repro_torch.serving.scenarios import build_scenario, run_scenario
from repro_torch.serving.tenancy import POOL_POLICIES, TenantPool

SEED = 7
ZOO = ("mixed-zoo", "mixed-zoo-rush")


def _f(x):
    """NaN-safe equality for report floats."""
    return "nan" if isinstance(x, float) and np.isnan(x) else x


def _decision_sig(report):
    return [(t, d.c, d.b, d.n, d.feasible)
            for t, d in (report.decisions or [])]


def _sig(report):
    """The reference test's signature, its core-seconds rounded to 1e-6."""
    return (_decision_sig(report), report.buckets, report.n_requests,
            report.n_violations, round(report.core_seconds, 6))


def _full_sig(report):
    """Everything that must match across packages, floats with ``==``."""
    return (_decision_sig(report), report.buckets, report.n_requests,
            report.n_violations, report.core_seconds, _f(report.p50),
            _f(report.p99), report.core_timeline, report.violation_rate,
            report.avg_cores, _f(report.mean_latency))


# --------------------------------------------------------------------------
# decision identity: fast == exact oracle, and both == the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POOL_POLICIES)
@pytest.mark.parametrize("name", ZOO)
def test_fast_matches_exact_oracle(name, policy):
    kw = dict(duration=60, seed=SEED, tenant_policy=policy)
    r_fast, s_fast = run_scenario(name, engine="fast", budget_quantum=0.0,
                                  lam_quantum=0.0, **kw)
    r_ex, s_ex = run_scenario(name, engine="exact", **kw)
    assert _sig(r_fast) == _sig(r_ex)
    assert s_fast["pool"]["caps"] == s_ex["pool"]["caps"]
    assert s_fast["pool"]["swaps"] == s_ex["pool"]["swaps"]
    for tf, te in zip(s_fast["tenant_reports"], s_ex["tenant_reports"]):
        assert _sig(tf) == _sig(te)


@pytest.mark.parametrize("engine", ["fast", "exact"])
@pytest.mark.parametrize("policy", POOL_POLICIES)
@pytest.mark.parametrize("name", ZOO)
def test_pool_equals_reference(name, policy, engine):
    """The port's pool run equals the reference's on the same scenario:
    the pool's stats, every tenant's report and the aggregate (the fast
    engine at its default quanta, as ``run_scenario`` runs it)."""
    kw = dict(engine=engine, duration=40, seed=SEED, tenant_policy=policy)
    rep, stats = run_scenario(name, **kw)
    jrep, jstats = jax_scenarios.run_scenario(name, **kw)
    assert _full_sig(rep) == _full_sig(jrep)
    assert (rep.policy, rep.backend) == (jrep.policy, jrep.backend)
    assert stats["pool"] == jstats["pool"]
    assert stats["events"] == jstats["events"]
    assert stats["tenants"] == jstats["tenants"]
    for tr, jtr in zip(stats["tenant_reports"], jstats["tenant_reports"]):
        assert _full_sig(tr) == _full_sig(jtr)


@pytest.mark.parametrize("name", ZOO)
def test_pool_cap_log_and_swaps_equal_reference(name):
    """Swap for swap: the timed ``(donor, receiver, amount)`` transfers
    and every round's caps, through the runners the engines build."""
    from repro.serving.tenancy import TenantFastRunner as JFast
    from repro_torch.serving.tenancy import TenantFastRunner
    _, meta = build_scenario(name, duration=40, seed=SEED)
    _, jmeta = jax_scenarios.build_scenario(name, duration=40, seed=SEED)
    runner = TenantFastRunner(meta["tenants"], budget=meta["pool_cores"],
                              tick=meta["tick"])
    jrunner = JFast(jmeta["tenants"], budget=jmeta["pool_cores"],
                    tick=jmeta["tick"])
    runner.run()
    jrunner.run()
    assert runner.pool.swaps == jrunner.pool.swaps
    assert runner.pool.cap_log == jrunner.pool.cap_log
    assert runner.core_timeline == jrunner.core_timeline
    assert runner.events_processed == jrunner.events_processed


@pytest.mark.parametrize("name", ZOO)
def test_zoo_builds_equal_reference(name):
    batch, meta = build_scenario(name, duration=30, seed=SEED)
    jbatch, jmeta = jax_scenarios.build_scenario(name, duration=30,
                                                 seed=SEED)
    np.testing.assert_array_equal(batch.arrival, jbatch.arrival)
    np.testing.assert_array_equal(batch.deadline, jbatch.deadline)
    assert [s.name for s in meta["tenants"]] == \
        [s.name for s in jmeta["tenants"]] == \
        ["whisper-large-v3", "smollm-135m", "rwkv6-1.6b"]
    for s, js in zip(meta["tenants"], jmeta["tenants"]):
        np.testing.assert_array_equal(s.batch.deadline, js.batch.deadline)
        assert (s.expected_rps, s.weight, s.priority, s.n0) == \
            (js.expected_rps, js.weight, js.priority, js.n0)
    for k in ("slo", "expected_rps", "pool_cores", "tick"):
        assert meta[k] == jmeta[k], k


def test_vector_engine_refuses_the_zoo():
    with pytest.raises(ValueError, match="vector"):
        run_scenario("mixed-zoo", engine="vector", duration=10)
    with pytest.raises(ValueError, match="sponge policy"):
        run_scenario("mixed-zoo", policy="fa2", duration=10)


# --------------------------------------------------------------------------
# reallocator properties (the pool driven directly)
# --------------------------------------------------------------------------
def _zoo_pool(policy, **kw):
    """A TenantPool over the real mixed-zoo specs with solver tables
    bound -- the same frontier the engines price against."""
    _, meta = build_scenario("mixed-zoo", duration=5, seed=0)
    specs = list(meta["tenants"])
    pool = TenantPool(specs, budget=128, policy=policy, **kw)
    for k, s in enumerate(specs):
        pool.bind_table(k, JointSolverTable(s.cost, s.c_set, s.b_set,
                                            s.n_set))
    return pool


def _idle(k):
    return [(np.empty(0), 0.0, 0.0)] * k


@pytest.mark.parametrize("policy", POOL_POLICIES)
def test_swaps_never_violate_pool_budget(policy):
    pool = _zoo_pool(policy, swap_step=8, swap_patience=1, min_cores=4)
    rng = np.random.default_rng(0)
    for round_i in range(60):
        snaps = []
        for _ in pool.specs:
            rem = np.sort(rng.exponential(0.3, rng.integers(0, 25)))
            snaps.append((rem, float(rng.uniform(0.0, 400.0)),
                          float(rng.uniform(0.0, 0.2))))
        pool.reallocate(float(round_i), snaps)
        assert sum(pool.caps) <= pool.budget, (round_i, pool.caps)
        assert all(c >= pool.min_cores for c in pool.caps), pool.caps
    assert len(pool.cap_log) == 60
    for _, caps in pool.cap_log:
        assert sum(caps) <= pool.budget


def test_fair_share_converges_to_proportional():
    pool = _zoo_pool("fair-share", initial_caps=(88, 20, 20))
    assert pool.caps != pool._targets
    for i in range(20):
        pool.reallocate(float(i), _idle(len(pool.specs)))
    assert pool.caps == pool._targets
    assert sum(pool.caps) == pool.budget
    tail = pool.cap_log[-1][1]
    for i in range(20, 25):
        pool.reallocate(float(i), _idle(len(pool.specs)))
    assert all(caps == tail for _, caps in pool.cap_log[-5:])
    assert not any(t >= 20 for t, *_ in pool.swaps)


def test_priority_starves_to_floor_without_livelock():
    pool = _zoo_pool("priority", swap_patience=1)
    prios = [s.priority for s in pool.specs]
    top = prios.index(min(prios))
    lam = pool._tables[top].max_rate(pool.budget) + 200.0
    init = list(pool.caps)
    for i in range(40):
        snaps = [(np.empty(0), lam if k == top else 0.0, 0.0)
                 for k in range(len(pool.specs))]
        pool.reallocate(float(i), snaps)
        assert sum(pool.caps) <= pool.budget
    assert pool.caps[top] > init[top]
    for k in range(len(pool.specs)):
        if k != top:
            assert pool.caps[k] < init[k], (k, pool.caps)
            assert pool.caps[k] - pool.swap_step < pool.min_cores
    tail = pool.cap_log[-1][1]
    assert all(caps == tail for _, caps in pool.cap_log[-5:])


def test_overflow_pricing_signals_before_backlog_exists():
    pool = _zoo_pool("greedy-marginal")
    table = pool._tables[0]
    cap = pool.caps[0]
    assert table.max_rate(cap + pool.swap_step) > table.max_rate(cap)
    lam = table.max_rate(cap) + 50.0
    prof = pool.marginal_profile(0, (np.empty(0), lam, 0.0))
    assert prof["v"] > 0.0
    assert prof["gain"] > 0.0
    idle = pool.marginal_profile(0, (np.empty(0), 0.0, 0.0))
    assert idle["v"] == idle["gain"] == 0.0


def test_pool_constructor_validation():
    _, meta = build_scenario("mixed-zoo", duration=5, seed=0)
    specs = list(meta["tenants"])
    with pytest.raises(KeyError):
        TenantPool(specs, policy="round-robin")
    with pytest.raises(ValueError):
        TenantPool(specs, budget=8, min_cores=4)
    with pytest.raises(ValueError):
        TenantPool(specs, budget=128, initial_caps=(100, 100, 100))
    with pytest.raises(ValueError):
        TenantPool(specs, budget=128, initial_caps=(2, 2, 124))
    pool = TenantPool(specs, budget=128)
    assert sum(pool._targets) == 128
    assert pool.caps == pool._targets


def test_priority_starved_tenant_reports_violations():
    batch, _ = build_scenario("mixed-zoo", duration=60, seed=SEED)
    report, stats = run_scenario("mixed-zoo", engine="fast", duration=60,
                                 seed=SEED, tenant_policy="priority")
    assert report.n_requests == len(batch)
    assert sum(t["n_requests"] for t in stats["tenants"].values()) == \
        len(batch)
    specs = stats["meta"]["tenants"]
    starved = max(specs, key=lambda s: s.priority).name
    assert stats["tenants"][starved]["violation_rate"] > 0.0
    assert np.isfinite(report.core_seconds)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_launcher_tenants_and_pool_cores(engine, capsys):
    out = launcher.main(["--scenario", "mixed-zoo", "--duration", "20",
                         "--engine", engine, "--tenants", "fair-share",
                         "--pool-cores", "96", "--seed", "3"])
    rep, stats = jax_scenarios.run_scenario(
        "mixed-zoo", engine=engine, duration=20, seed=3,
        tenant_policy="fair-share", pool_cores=96)
    assert out["pool_policy"] == "fair-share" and out["pool_cores"] == 96
    assert sum(out["pool_caps"]) <= 96
    assert out["pool_caps"] == list(stats["pool"]["caps"])
    assert out["pool_swaps"] == stats["pool"]["swaps"]
    assert out["n"] == rep.n_requests
    assert set(out["tenants"]) == {"whisper-large-v3", "smollm-135m",
                                   "rwkv6-1.6b"}
    for name, t in out["tenants"].items():
        assert t["violation_rate"] == stats["tenants"][name]["violation_rate"]
    assert '"pool_swaps"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launcher.main(["--scenario", "mixed-zoo", "--tenants", "round-robin"])
