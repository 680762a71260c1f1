"""The port's scenario registry and exact-engine runner against the JAX package.

``serving/scenarios.py``, ``network/traces.py`` and the launcher's
scenario branch are NumPy copies of the reference's, so the same seed
must give the same workload columns and the same exact-engine run:
equal reports, decision streams, buckets, session counts and
uncertainty stats, with no float tolerance.  Mirrors the exact-engine
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
# the reference's registration order of the single-instance scenarios
ORDER = ("steady", "diurnal", "flash-crowd", "network-replay", "mixed-slo",
         "llm-chat", "llm-mixed-len", "llm-heavy-tail",
         "retrieve-then-generate", "slo-renegotiation", "cancel-storm")


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
    with pytest.raises(KeyError):
        scenarios.get_scenario("replica-failure")


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
    rep, stats = scenarios.run_scenario("steady", duration=20, seed=2)
    jrep, _ = jax_scenarios.run_scenario("steady", engine="exact",
                                         duration=20, seed=2)
    assert stats["engine"] == "exact"
    assert report_sig(rep) == report_sig(jrep)


@pytest.mark.parametrize("policy", ["fa2", "static-8"])
@pytest.mark.parametrize("name", ["mixed-slo", "slo-renegotiation"])
def test_run_scenario_baselines_equal_reference(name, policy):
    rep, stats = scenarios.run_scenario(name, policy=policy, duration=30,
                                        seed=5)
    jrep, jstats = jax_scenarios.run_scenario(name, policy=policy,
                                              engine="exact", duration=30,
                                              seed=5)
    assert report_sig(rep) == report_sig(jrep)
    assert stats.get("session") == jstats.get("session")


@pytest.mark.parametrize("engine", ["fast", "vector", "jax"])
def test_unported_engines_raise(engine):
    with pytest.raises(ValueError, match="6b"):
        scenarios.run_scenario("steady", engine=engine, duration=10)


@pytest.mark.parametrize("kw", [dict(name="steady", admission_quantile=0.9),
                                dict(name="llm-heavy-tail",
                                     admission_quantile=1.2),
                                dict(name="llm-chat", policy="fa2")])
def test_run_scenario_validation_matches_reference(kw):
    name = kw.pop("name")
    with pytest.raises(ValueError):
        jax_scenarios.run_scenario(name, engine="exact", duration=10, **kw)
    with pytest.raises(ValueError):
        scenarios.run_scenario(name, duration=10, **kw)


def test_flash_crowd_overload_is_localized():
    """``tests/test_scenarios.py``'s overload case on the exact engine:
    the spikes exceed capacity, the base load around them is served."""
    batch, _ = scenarios.build_scenario("flash-crowd", duration=120, seed=7)
    rep, _ = scenarios.run_scenario("flash-crowd", duration=120, seed=7)
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
# the launcher's exact-engine branch
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
    with contextlib.redirect_stdout(io.StringIO()):
        out = launcher.main(["--scenario", "steady", "--duration", "10"])
    assert out["engine"] == "exact"


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
