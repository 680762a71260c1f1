"""The port's scenario registry and runner against the JAX package.

``serving/scenarios.py``, ``network/traces.py`` and the launcher's
scenario branch are NumPy copies of the reference's, so the same seed
must give the same workload columns and the same run on the fast and
exact engines: equal reports, decision streams, buckets, session counts,
solver and uncertainty stats, with no float tolerance.  Mirrors the
cases of ``tests/test_scenarios.py``.  Everything here runs on the CPU.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from repro.launch import serve as jax_launcher
from repro.network import traces as jax_traces
from repro.serving import scenarios as jax_scenarios
from repro_torch.launch import serve as launcher
from repro_torch.network import traces
from repro_torch.serving import scenarios
from repro_torch.serving.api import RunReport

PLAIN = ("steady", "diurnal", "flash-crowd", "network-replay", "mixed-slo")
SESSION = ("slo-renegotiation", "cancel-storm")
TOKEN = ("llm-chat", "llm-mixed-len", "llm-heavy-tail",
         "retrieve-then-generate")
ALL = PLAIN + TOKEN + SESSION
FLEET = ("replica-failure", "rolling-restart", "fleet-flash-crowd")
DEGRADE = ("degrade-sustained-overload", "degrade-flash-overload",
           "degrade-fade-overload")
# the reference's registration order of the scenarios (all of them,
# the multi-tenant mixed-zoo pair included)
ORDER = ("steady", "diurnal", "flash-crowd", "network-replay", "mixed-slo",
         "llm-chat", "llm-mixed-len", "llm-heavy-tail",
         "retrieve-then-generate") + FLEET + DEGRADE + (
         "mixed-zoo", "mixed-zoo-rush", "slo-renegotiation", "cancel-storm")


def report_sig(rep):
    """Every field of the port's ``RunReport`` (the reference's has
    fleet and ladder fields besides), NaN-safe (``repr`` of the floats),
    and every decision but its wall-clock solver time."""
    decisions = [(t, d.c, d.b, d.feasible, d.solver_iters, d.n,
                  d.scale_up_delay, d.predicted_tbt, d.m)
                 for t, d in (rep.decisions or [])]
    fields = {f.name: getattr(rep, f.name)
              for f in dataclasses.fields(RunReport)
              if f.name != "decisions"}
    return repr((fields, decisions))


def columns(batch):
    return {f.name: getattr(batch, f.name)
            for f in dataclasses.fields(batch) if f.name != "decode_dist"}


def test_registry_holds_the_single_instance_scenarios_in_order():
    assert tuple(scenarios.SCENARIOS) == ORDER
    ref = jax_scenarios.SCENARIOS
    for name, sc in scenarios.SCENARIOS.items():
        assert (sc.summary, sc.default_rps, sc.default_duration,
                sc.mean_rate_factor) == (ref[name].summary,
                                         ref[name].default_rps,
                                         ref[name].default_duration,
                                         ref[name].mean_rate_factor), name
    assert scenarios.list_scenarios() == {
        k: v for k, v in jax_scenarios.list_scenarios().items() if k in ORDER}
    assert tuple(ref) == ORDER
    assert scenarios.get_scenario("mixed-zoo").name == "mixed-zoo"
    with pytest.raises(KeyError):
        scenarios.get_scenario("no-such-scenario")


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", ALL)
def test_build_scenario_equals_reference(name, seed):
    batch, meta = scenarios.build_scenario(name, seed=seed, duration=40)
    ref, jmeta = jax_scenarios.build_scenario(name, seed=seed, duration=40)
    np.testing.assert_equal(columns(batch), columns(ref))
    assert len(batch) > 0 and np.all(np.diff(batch.arrival) >= 0)
    assert set(meta) == set(jmeta)
    for k, v in meta.items():
        if k in ("trace", "trace_5g"):
            np.testing.assert_equal(dataclasses.asdict(v),
                                    dataclasses.asdict(jmeta[k]))
        elif k in ("cost", "decode_dist"):
            assert repr(v) == repr(jmeta[k]), k
        else:
            assert v == jmeta[k], k
    if batch.decode_dist is not None:
        assert repr(batch.decode_dist) == repr(ref.decode_dist)


@pytest.mark.parametrize("name,requests", [("steady", 2000),
                                           ("flash-crowd", 1500),
                                           ("diurnal", 1200),
                                           ("cancel-storm", 600)])
def test_requests_knob_sizes_the_run(name, requests):
    batch, meta = scenarios.build_scenario(name, requests=requests, seed=1)
    ref, jmeta = jax_scenarios.build_scenario(name, requests=requests,
                                              seed=1)
    assert meta["duration"] == jmeta["duration"]
    np.testing.assert_equal(columns(batch), columns(ref))
    assert len(batch) == pytest.approx(requests, rel=0.25)


@pytest.mark.parametrize("name", ALL)
def test_run_scenario_exact_equals_reference(name):
    rep, stats = scenarios.run_scenario(name, engine="exact", duration=30,
                                        seed=3)
    jrep, jstats = jax_scenarios.run_scenario(name, engine="exact",
                                              duration=30, seed=3)
    assert report_sig(rep) == report_sig(jrep)
    assert rep.n_requests > 0 and rep.decisions
    assert stats["engine"] == "exact"
    assert stats["events"] == jstats["events"] > 0
    for k in ("session", "uncertainty"):
        assert stats.get(k) == jstats.get(k), k


def test_run_scenario_defaults_to_the_exact_engine():
    rep, stats = scenarios.run_scenario("steady", engine="exact",
                                        duration=20, seed=2)
    jrep, _ = jax_scenarios.run_scenario("steady", engine="exact",
                                         duration=20, seed=2)
    assert stats["engine"] == "exact"
    assert report_sig(rep) == report_sig(jrep)


@pytest.mark.parametrize("policy", ["fa2", "static-8"])
@pytest.mark.parametrize("name", ["mixed-slo", "slo-renegotiation"])
def test_run_scenario_baselines_equal_reference(name, policy):
    rep, stats = scenarios.run_scenario(name, policy=policy, engine="exact",
                                        duration=30, seed=5)
    jrep, jstats = jax_scenarios.run_scenario(name, policy=policy,
                                              engine="exact", duration=30,
                                              seed=5)
    assert report_sig(rep) == report_sig(jrep)
    assert stats.get("session") == jstats.get("session")


@pytest.mark.parametrize("engine", ["fast", "vector", "jax"])
def test_unported_engines_raise(engine):
    """``jax`` is refused; ``fast`` and ``vector`` are ported and give
    the reference's runs, and ``vector`` refuses what the reference's
    refuses (a session scenario)."""
    if engine == "jax":
        with pytest.raises(ValueError, match="jax"):
            scenarios.run_scenario("steady", engine=engine, duration=10)
        return
    rep, stats = scenarios.run_scenario("steady", engine=engine,
                                        duration=10)
    jrep, jstats = jax_scenarios.run_scenario("steady", engine=engine,
                                              duration=10)
    assert report_sig(rep) == report_sig(jrep)
    assert stats["solver"] == jstats["solver"]
    assert stats["events"] == jstats["events"] > 0
    if engine == "vector":
        for run in (scenarios.run_scenario, jax_scenarios.run_scenario):
            with pytest.raises(ValueError, match="vector"):
                run("slo-renegotiation", engine=engine, duration=10)


@pytest.mark.parametrize("kw", [dict(name="steady", admission_quantile=0.9),
                                dict(name="llm-heavy-tail",
                                     admission_quantile=1.2),
                                dict(name="llm-chat", policy="fa2")])
def test_run_scenario_validation_matches_reference(kw):
    name = kw.pop("name")
    with pytest.raises(ValueError):
        jax_scenarios.run_scenario(name, engine="exact", duration=10, **kw)
    with pytest.raises(ValueError):
        scenarios.run_scenario(name, engine="exact", duration=10, **kw)


@pytest.mark.parametrize("name", ALL)
def test_run_scenario_fast_equals_reference(name):
    """The default engine (fast, quantized memo solver) on every
    scenario: the report, event count and session, solver and
    uncertainty stats equal the reference's fast engine."""
    rep, stats = scenarios.run_scenario(name, duration=30, seed=3)
    jrep, jstats = jax_scenarios.run_scenario(name, engine="fast",
                                              duration=30, seed=3)
    assert report_sig(rep) == report_sig(jrep)
    assert rep.n_requests > 0 and rep.decisions
    assert stats["engine"] == "fast"
    assert stats["events"] == jstats["events"] > 0
    assert stats["solver"]["hits"] + stats["solver"]["misses"] > 0
    for k in ("session", "uncertainty", "solver"):
        assert stats.get(k) == jstats.get(k), k


@pytest.mark.parametrize("name", PLAIN + SESSION)
def test_fast_at_quanta_zero_equals_exact(name):
    """At quanta 0 the fast engine is decision for decision the exact
    one (``test_determinism.py`` / ``test_fastpath.py``): decisions,
    buckets, request, violation and cancel counts, session counts."""
    fast, fstats = scenarios.run_scenario(name, duration=60, seed=1,
                                          budget_quantum=0.0,
                                          lam_quantum=0.0)
    exact, estats = scenarios.run_scenario(name, engine="exact",
                                           duration=60, seed=1)
    assert [(t, d.c, d.b, d.n, d.feasible) for t, d in fast.decisions] \
        == [(t, d.c, d.b, d.n, d.feasible) for t, d in exact.decisions]
    assert fast.buckets == exact.buckets
    assert (fast.n_requests, fast.n_violations, fast.n_cancelled) == \
        (exact.n_requests, exact.n_violations, exact.n_cancelled)
    assert fstats.get("session") == estats.get("session")


def test_fast_and_exact_agree_on_request_counts():
    for name in PLAIN:
        fast, _ = scenarios.run_scenario(name, duration=45, seed=2)
        exact, _ = scenarios.run_scenario(name, engine="exact", duration=45,
                                          seed=2)
        assert fast.n_requests == exact.n_requests, name


def test_run_scenario_defaults_to_the_fast_engine():
    rep, stats = scenarios.run_scenario("steady", duration=20, seed=2)
    jrep, jstats = jax_scenarios.run_scenario("steady", duration=20, seed=2)
    assert stats["engine"] == jstats["engine"] == "fast"
    assert report_sig(rep) == report_sig(jrep)
    assert stats["solver"] == jstats["solver"]


@pytest.mark.parametrize("name", ["steady", "slo-renegotiation"])
def test_sponge_pred_requires_exact_engine(name):
    for run in (scenarios.run_scenario, jax_scenarios.run_scenario):
        with pytest.raises(ValueError, match="exact"):
            run(name, policy="sponge-pred", engine="fast", duration=10)


def test_flash_crowd_overload_is_localized():
    """``tests/test_scenarios.py``'s overload case on the exact engine:
    the spikes exceed capacity, the base load around them is served."""
    batch, _ = scenarios.build_scenario("flash-crowd", duration=120, seed=7)
    rep, _ = scenarios.run_scenario("flash-crowd", engine="exact",
                                    duration=120, seed=7)
    assert rep.violation_rate < 0.6
    assert rep.n_requests == len(batch)


# --------------------------------------------------------------------------
# traces and arrival processes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("duration", [30, 700])
def test_5g_trace_equals_reference(duration, seed):
    tr = traces.synth_5g_trace(duration, seed=seed)
    ref = jax_traces.synth_5g_trace(duration, seed=seed)
    np.testing.assert_equal(tr.mbps, ref.mbps)
    np.testing.assert_equal(tr.t, ref.t)
    assert tr.mbps.max() <= 40.0 and tr.mbps.min() >= 1.5


def test_csv_trace_equals_reference(tmp_path):
    path = tmp_path / "trace.csv"
    rng = np.random.default_rng(0)
    rows = [f"{i},{v:.1f}" for i, v in enumerate(rng.uniform(1e5, 8e6, 40))]
    path.write_text("\n".join(rows) + "\n")
    tr = traces.load_csv_trace(str(path))
    ref = jax_traces.load_csv_trace(str(path))
    np.testing.assert_equal(tr.mbps, ref.mbps)
    assert tr.duration == ref.duration == 39.0


def test_inhomogeneous_poisson_equals_reference():
    def rate(t):
        return 5.0 + 4.0 * np.sin(t)

    mine = scenarios.inhomogeneous_poisson_times(
        rate, 9.0, 60.0, np.random.default_rng(4))
    ref = jax_scenarios.inhomogeneous_poisson_times(
        rate, 9.0, 60.0, np.random.default_rng(4))
    np.testing.assert_equal(mine, ref)
    assert mine.size > 0 and np.all(np.diff(mine) >= 0)


# --------------------------------------------------------------------------
# the launcher's fast- and exact-engine branches
# --------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--scenario", "slo-renegotiation", "--duration", "30"],
    ["--scenario", "slo-renegotiation", "--duration", "30",
     "--no-mid-flight"],
    ["--scenario", "cancel-storm", "--duration", "30", "--seed", "4"],
    ["--scenario", "network-replay", "--duration", "20"],
    ["--scenario", "llm-heavy-tail", "--duration", "20",
     "--admission-quantile", "0.8"],
    ["--scenario", "retrieve-then-generate", "--duration", "20",
     "--no-speculative"],
    ["--scenario", "llm-chat", "--duration", "20"],
])
def test_launcher_exact_json_equals_reference(argv, capsys):
    out = launcher.main(argv + ["--engine", "exact"])
    mine = json.loads(capsys.readouterr().out)
    jax_launcher.main(argv + ["--engine", "exact"])
    ref = json.loads(capsys.readouterr().out)
    assert mine == out
    shared = set(mine) & set(ref)
    assert set(ref) - shared <= {"solver_hit_rate"}
    assert set(mine) == shared
    timing = {"wall_s", "events_per_s"}
    assert {k: mine[k] for k in shared - timing} \
        == {k: ref[k] for k in shared - timing}
    assert mine["engine"] == "exact" and mine["n"] > 0


def test_launcher_defaults_plain_scenarios_to_the_exact_engine():
    """The launcher's default engine for a plain scenario: the fast
    engine now that it is ported, as in the reference (it was the exact
    engine while that was the only one); ``--engine exact`` still picks
    the exact engine."""
    with contextlib.redirect_stdout(io.StringIO()):
        out = launcher.main(["--scenario", "steady", "--duration", "10"])
        exact = launcher.main(["--scenario", "steady", "--duration", "10",
                               "--engine", "exact"])
    assert out["engine"] == "fast"
    assert exact["engine"] == "exact"


@pytest.mark.parametrize("argv", [
    ["--scenario", "steady", "--duration", "30"],
    ["--scenario", "mixed-slo", "--duration", "30", "--policy", "fa2"],
    ["--scenario", "slo-renegotiation", "--duration", "30"],
    ["--scenario", "cancel-storm", "--duration", "30", "--no-mid-flight"],
    ["--scenario", "llm-heavy-tail", "--duration", "20",
     "--admission-quantile", "0.8", "--engine", "fast"],
    ["--scenario", "llm-chat", "--duration", "20", "--engine", "fast"],
])
def test_launcher_fast_json_equals_reference(argv, capsys):
    """The fast engine through the launcher: every key of the
    reference's JSON line, ``solver_hit_rate`` included, but the wall
    clock."""
    out = launcher.main(argv)
    mine = json.loads(capsys.readouterr().out)
    jax_launcher.main(argv)
    ref = json.loads(capsys.readouterr().out)
    assert mine == out and mine["engine"] == "fast" and mine["n"] > 0
    assert set(mine) == set(ref)
    timing = {"wall_s", "events_per_s"}
    assert {k: mine[k] for k in set(mine) - timing} \
        == {k: ref[k] for k in set(ref) - timing}
    if "--policy" not in argv:
        assert mine["solver_hit_rate"] > 0


def test_launcher_refuses_the_vector_engine():
    """``--engine vector`` replays the plain scenarios only; on any
    other scenario the launcher raises as the reference's does."""
    argv = ["--scenario", "llm-chat", "--duration", "10",
            "--engine", "vector"]
    for main in (launcher.main, jax_launcher.main):
        with pytest.raises(ValueError, match="vector"):
            main(argv)


@pytest.mark.parametrize("argv", [
    ["--scenario", "llm-heavy-tail", "--admission-quantile", "1.5",
     "--engine", "exact"],
    ["--scenario", "llm-heavy-tail", "--engine", "torch",
     "--admission-quantile", "0.9"],
    ["--scenario", "llm-heavy-tail", "--engine", "torch",
     "--no-speculative"],
])
def test_launcher_rejects_what_the_reference_rejects(argv):
    with pytest.raises(SystemExit):
        launcher.main(argv)
