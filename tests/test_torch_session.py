"""The port's online session API against the JAX package.

``serving/session.py`` is a copy of the reference's single-instance
sessions: the same workload and the same ``update_slo`` / ``cancel``
stream must give the same reports, decision streams and applied counts,
float for float.  Mirrors the exact- and fast-engine cases of
``tests/test_session.py`` (replay equivalence, the renegotiation
microcases, cancel accounting, exact == fast under renegotiation) and
holds a live session on the reduced smollm (``TorchBackend``, the
modelled clock, on the CPU) to ``run_scenario(engine="exact")``.
"""
import numpy as np
import pytest
import torch

from repro.core.baselines import FA2Policy as JaxFA2Policy
from repro.core.baselines import SpongePolicy as JaxSpongePolicy
from repro.core.baselines import StaticPolicy as JaxStaticPolicy
from repro.core.perf_model import yolov5s_like as jax_yolo
from repro.core.scaler import SpongeScaler as JaxSpongeScaler
from repro.core.scaler import TokenSpongeScaler as JaxTokenSpongeScaler
from repro.network.traces import synth_4g_trace as jax_synth_4g_trace
from repro.serving import api as japi
from repro.serving import fastpath as jax_fastpath
from repro.serving import scenarios as jax_scenarios
from repro.serving import session as jax_session
from repro.serving.workload import WorkloadGenerator as JaxWorkloadGenerator
from repro_torch.core.baselines import FA2Policy, SpongePolicy, StaticPolicy
from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.scaler import SpongeScaler, TokenSpongeScaler
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving import api
from repro_torch.serving.fastpath import FastSimRunner, TokenFastSimRunner
from repro_torch.serving.scenarios import build_scenario, run_scenario
from repro_torch.serving.session import (ExactSession, FastSession,
                                         SessionTranscript, SpongeSession,
                                         TokenFastSession,
                                         drive_session_events,
                                         replay_transcript)
from repro_torch.serving.workload import WorkloadGenerator

SESSION = ("slo-renegotiation", "cancel-storm")


def stream(report):
    return [(t, d.c, d.b, d.n, d.scale_up_delay, d.feasible)
            for t, d in (report.decisions or [])]


def sig(report):
    return repr((stream(report), report.buckets, report.n_requests,
                 report.n_violations, report.n_cancelled,
                 report.core_seconds, report.p50, report.p99,
                 report.core_timeline))


def runners(policy="sponge", c_set=DEFAULT_C, b_set=DEFAULT_B, c0=16,
            tick=1.0, prior_rps=20.0):
    """The same ``ScenarioRunner`` over ``SimBackend`` in both packages."""
    out = []
    for mod, perf, sponge, scaler, static in (
            (api, yolov5s_like(), SpongePolicy, SpongeScaler, StaticPolicy),
            (japi, jax_yolo(), JaxSpongePolicy, JaxSpongeScaler,
             JaxStaticPolicy)):
        pol = (sponge(scaler(perf)) if policy == "sponge"
               else static(perf, cores=8))
        r = mod.ScenarioRunner(pol, mod.SimBackend(perf, c_set, b_set,
                                                   c0=c0), tick=tick)
        r.monitor.rate.prior_rps = prior_rps
        out.append(r)
    return out


# --------------------------------------------------------------------------
# replay equivalence: a transcript driven op by op == the batch run
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["steady", "mixed-slo"])
def test_transcript_replay_matches_batch_run_exact(name):
    batch, _ = build_scenario(name, duration=40, seed=7)
    jbatch, _ = jax_scenarios.build_scenario(name, duration=40, seed=7)
    ref = runners()[0].run(batch.to_requests())
    mine = replay_transcript(runners()[0].session(),
                             SessionTranscript.from_batch(batch), batch)
    jax = jax_session.replay_transcript(
        runners()[1].session(), jax_session.SessionTranscript.from_batch(
            jbatch), jbatch)
    assert sig(mine) == sig(ref) == sig(jax)
    assert mine.n_cancelled == 0 and mine.n_requests == len(batch)


@pytest.mark.parametrize("name", SESSION)
def test_transcript_with_events_equals_reference(name):
    """A transcript that carries the scenario's update/cancel stream,
    replayed op by op, gives the reference's run."""
    batch, meta = build_scenario(name, duration=30, seed=2)
    jbatch, jmeta = jax_scenarios.build_scenario(name, duration=30, seed=2)
    tr = SessionTranscript.from_batch(batch, meta["session_events"])
    jtr = jax_session.SessionTranscript.from_batch(
        jbatch, jmeta["session_events"])
    assert tr.ops == jtr.ops
    mine, jax = runners(tick=0.5)
    rep = replay_transcript(mine.session(), tr, batch)
    jrep = jax_session.replay_transcript(jax.session(), jtr, jbatch)
    assert sig(rep) == sig(jrep)


@pytest.mark.parametrize("mid_flight", [True, False])
@pytest.mark.parametrize("name", SESSION)
def test_session_scenario_applied_counts_equal_reference(name, mid_flight):
    rep, stats = run_scenario(name, engine="exact", duration=50, seed=13,
                              mid_flight=mid_flight)
    jrep, jstats = jax_scenarios.run_scenario(name, engine="exact",
                                              duration=50, seed=13,
                                              mid_flight=mid_flight)
    assert stats["session"] == jstats["session"]
    assert sig(rep) == sig(jrep)
    if mid_flight:
        assert sum(stats["session"].values()) == \
            len(build_scenario(name, duration=50, seed=13)[1][
                "session_events"])
    else:
        assert stats["session"] == {"update": 0, "cancel": 0, "noop": 0}


# --------------------------------------------------------------------------
# renegotiation semantics on the exact engine
# --------------------------------------------------------------------------
def _backlogged(mod_runner):
    """A static 8-core slot with a 6-deep arrival burst at t = 0.6 and
    loose deadlines: at t = 0.7 the burst still waits to fill its
    batch."""
    sess = mod_runner.session()
    hs = [sess.submit(send=0.5, comm_latency=0.1, slo=5.0)
          for _ in range(6)]
    return sess, hs


def test_update_slo_changes_outcome_microcase():
    """Tightening a queued request's deadline below its feasible finish
    turns the same completion into a violation, in both packages."""
    reports = []
    for runner in runners("static", c_set=(8,), b_set=(1, 2, 4, 8), c0=8):
        sess, hs = _backlogged(runner)
        sess.step_until(0.7)
        assert sess.record(hs[-1])["status"] == "queued"
        assert sess.update_slo(hs[-1], deadline=0.71)
        rep = sess.finish(30.0)
        assert rep.n_requests == 6 and rep.n_violations == 1
        rec = sess.record(hs[-1])
        assert rec["status"] == "done" and rec["violated"] is True
        reports.append(rep)
    assert sig(reports[0]) == sig(reports[1])
    sess, _ = _backlogged(runners("static", c_set=(8,), b_set=(1, 2, 4, 8),
                                  c0=8)[0])
    assert sess.finish(30.0).n_violations == 0


@pytest.mark.parametrize("relax", [False, True])
def test_relaxed_budget_avoids_violation(relax):
    """The mirror case: a hopeless submit-time deadline relaxed before
    the request arrives (the network recovered) completes clean.  (On
    the exact engine a queued hopeless head dispatches at once, so the
    renegotiation lands while the request is pending.)"""
    reports = []
    for runner in runners("static", c_set=(8,), b_set=(1, 2, 4, 8), c0=8):
        sess = runner.session()
        hs = [sess.submit(send=0.5, comm_latency=0.1,
                          slo=5.0 if i < 5 else 0.25) for i in range(6)]
        sess.step_until(0.55)
        if relax:
            assert sess.record(hs[-1])["status"] == "pending"
            assert sess.update_slo(hs[-1], slo=5.0)
        reports.append(sess.finish(30.0))
    assert sig(reports[0]) == sig(reports[1])
    if relax:
        assert reports[0].n_violations == 0
    else:
        assert reports[0].n_violations >= 1


def test_cancelled_requests_leave_every_aggregate():
    reports = []
    for runner in runners():
        sess = runner.session()
        handles = [sess.submit(send=3.0 + 0.01 * i, comm_latency=0.2,
                               slo=8.0) for i in range(20)]
        assert sess.cancel(handles[-1])           # before its arrival
        sess.step_until(3.3)
        cancelled = [h for h in handles[:10] if sess.cancel(h)]
        assert cancelled, "some requests must still be queued at t=3.3"
        assert not sess.cancel(cancelled[0])      # double cancel
        assert not sess.update_slo(cancelled[0], slo=9.0)
        assert sess.record(cancelled[0])["status"] == "cancelled"
        rep = sess.finish(40.0)
        assert rep.n_cancelled == len(cancelled) + 1
        assert rep.n_requests == 20 - rep.n_cancelled
        assert rep.n_violations == 0
        reports.append(rep)
    assert sig(reports[0]) == sig(reports[1])


def test_pending_cancel_is_counted():
    for runner in runners():
        sess = runner.session()
        hs = [sess.submit(send=2.0 + 0.1 * i, comm_latency=0.1, slo=8.0)
              for i in range(5)]
        assert sess.cancel(hs[3])
        rep = sess.finish(30.0)
        assert rep.n_cancelled == 1 and rep.n_requests == 4


def test_cancel_deflates_lambda_window():
    lams = []
    for runner in runners():
        sess = runner.session()
        hs = [sess.submit(send=1.0 + 0.001 * i, comm_latency=0.5, slo=30.0)
              for i in range(50)]
        sess.step_until(1.6)
        before = runner.monitor.rate.rate(1.6)
        assert sum(sess.cancel(h) for h in hs[:40]) > 0
        after = runner.monitor.rate.rate(1.6)
        assert after < before
        lams.append((before, after))
    assert lams[0] == lams[1]


def test_session_guards():
    runner = runners()[0]
    sess = runner.session()
    assert isinstance(sess, ExactSession) and isinstance(sess, SpongeSession)
    h = sess.submit(send=1.0, comm_latency=0.1, slo=1.0)
    assert sess.record(h)["status"] == "pending"
    with pytest.raises(ValueError):
        sess.step_until(float("inf"))
    sess.step_until(2.0)
    with pytest.raises(ValueError):
        sess.submit(send=0.5, comm_latency=0.1)
    assert not sess.cancel(12345678) and not sess.update_slo(12345678,
                                                             slo=2.0)


def test_sponge_server_session_and_submit_batch():
    batch, meta = build_scenario("slo-renegotiation", duration=30, seed=4)
    server = api.make_sim_server(yolov5s_like(), "sponge", c0=16, tick=0.5,
                                 prior_rps=meta["expected_rps"],
                                 adaptation_interval=0.5)
    sess = server.session()
    assert isinstance(sess, SpongeSession)
    handles = sess.submit_batch(batch)
    assert len(handles) == len(batch) == len(set(handles))
    applied = drive_session_events(sess, handles, meta["session_events"])
    rep = sess.finish()
    ref, stats = run_scenario("slo-renegotiation", engine="exact",
                              duration=30, seed=4)
    assert applied == stats["session"] and applied["update"] > 0
    assert sig(rep) == sig(ref)


def test_cancel_storm_scenario_end_to_end():
    rep, stats = run_scenario("cancel-storm", engine="exact", duration=80,
                              seed=5)
    plain, pstats = run_scenario("cancel-storm", engine="exact",
                                 duration=80, seed=5, mid_flight=False)
    assert rep.n_cancelled > 0
    assert stats["session"]["cancel"] == rep.n_cancelled
    assert plain.n_cancelled == 0
    assert rep.n_requests + rep.n_cancelled == plain.n_requests
    assert rep.core_seconds <= plain.core_seconds + 1e-9


def test_slo_renegotiation_changes_decisions():
    """Renegotiated budgets move the (c, b) decision stream against the
    no-renegotiation replay of the same workload (exact engine)."""
    ev, stats = run_scenario("slo-renegotiation", engine="exact",
                             duration=120, seed=11)
    plain, _ = run_scenario("slo-renegotiation", engine="exact",
                            duration=120, seed=11, mid_flight=False)
    assert stats["session"]["update"] > 100
    d_ev = [(t, d.c, d.b) for t, d in ev.decisions]
    d_pl = [(t, d.c, d.b) for t, d in plain.decisions]
    assert len(d_ev) == len(d_pl)
    assert sum(a != b for a, b in zip(d_ev, d_pl)) > 0


# --------------------------------------------------------------------------
# a live session on the reduced smollm (modelled clock, CPU)
# --------------------------------------------------------------------------
LIVE_SETS = dict(c_set=(1, 2, 4, 8), b_set=(1, 2, 4, 8))
# the Fig. 4 perf model (a slower l(b, c) than the card's fit), so that
# queues form at these rates and the event streams find requests queued
LIVE_PERF = yolov5s_like()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def live_table():
    server, cfg = api.make_live_server(
        "smollm-135m-reduced", prompt_len=8, gen_tokens=2, perf=LIVE_PERF,
        device="cpu", **LIVE_SETS)
    return server.backend.step_fns, cfg


def live_session_run(fns, cfg, name, mid_flight, requests=80):
    """``name``'s first ``requests`` arrivals through a session on a
    ``TorchBackend`` over ``fns`` (modelled clock, prompts as payloads),
    with the scenario's event stream unless ``mid_flight`` is False."""
    batch, meta = build_scenario(name, requests=requests, seed=0)
    tick = meta.get("tick", 1.0)
    policy = api.make_policy("sponge", LIVE_PERF, adaptation_interval=tick,
                             slo=meta["slo"],
                             expected_rps=meta["expected_rps"], **LIVE_SETS)
    backend = api.TorchBackend(fns, api.pad_tokens, LIVE_PERF,
                               clock="modeled")
    server = api.SpongeServer(policy, backend, tick=tick,
                              prior_rps=meta["expected_rps"])
    sess = server.session()
    rng = np.random.default_rng(0)
    handles = [sess.submit(r, payload=rng.integers(
        0, cfg.vocab_size, 8).astype(np.int32)) for r in batch.to_requests()]
    events = meta.get("session_events", ()) if mid_flight else ()
    applied = drive_session_events(sess, handles, events)
    return sess.finish(), applied, backend


@pytest.mark.parametrize("mid_flight", [True, False])
@pytest.mark.parametrize("name", SESSION)
def test_live_session_modelled_clock_equals_exact_engine(live_table, name,
                                                         mid_flight):
    fns, cfg = live_table
    with torch.inference_mode():
        rep, applied, backend = live_session_run(fns, cfg, name, mid_flight)
    ref, stats = run_scenario(name, engine="exact", perf=LIVE_PERF,
                              requests=80, seed=0, c0=8,
                              mid_flight=mid_flight,
                              resize_penalty=0.0, **LIVE_SETS)
    assert stream(rep) == stream(ref) and rep.decisions
    assert rep.buckets == ref.buckets
    assert (rep.n_requests, rep.violation_rate, rep.n_cancelled) == \
        (ref.n_requests, ref.violation_rate, ref.n_cancelled)
    assert applied == stats["session"]
    ids = np.stack([it.result for it in backend.results])
    assert ids.shape == (rep.n_requests, 2)
    assert ((ids >= 0) & (ids < cfg.vocab_size)).all()
    if mid_flight and name == "cancel-storm":
        assert rep.n_cancelled == applied["cancel"] > 0
    if mid_flight and name == "slo-renegotiation":
        assert applied["update"] > 0


# --------------------------------------------------------------------------
# the struct-of-arrays sessions (FastSession, TokenFastSession)
# --------------------------------------------------------------------------


def fast_runners(policy="sponge", c_set=DEFAULT_C, b_set=DEFAULT_B, c0=16,
                 tick=1.0, prior_rps=0.0):
    """The same ``FastSimRunner`` in both packages."""
    out = []
    for mod, perf, sponge, scaler, static, fa2 in (
            (None, yolov5s_like(), SpongePolicy, SpongeScaler, StaticPolicy,
             FA2Policy),
            (jax_fastpath, jax_yolo(), JaxSpongePolicy, JaxSpongeScaler,
             JaxStaticPolicy, JaxFA2Policy)):
        pol = {"sponge": lambda: sponge(scaler(perf)),
               "fa2": lambda: fa2(perf, slo=1.0, expected_rps=20),
               "static": lambda: static(perf, cores=8)}[policy]()
        cls = FastSimRunner if mod is None else mod.FastSimRunner
        out.append(cls(pol, perf, c_set, b_set, c0=c0, tick=tick,
                       prior_rps=prior_rps))
    return out


def poisson_batches(seed=11, duration=60):
    """``test_session.py``'s Poisson workload in both packages."""
    return tuple(gen(rps=20, slo=1.0, size_kb=200, poisson=True,
                     seed=seed).generate_batch(tr(duration, seed=seed))
                 for gen, tr in ((WorkloadGenerator, synth_4g_trace),
                                 (JaxWorkloadGenerator, jax_synth_4g_trace)))


def eq_sig(report):
    """``sig`` as a tuple: exact equality across engines (an engine's
    ints may be numpy scalars, which ``repr`` tells apart)."""
    return (stream(report), report.buckets, report.n_requests,
            report.n_violations, report.n_cancelled, report.core_seconds,
            report.p50, report.p99, report.core_timeline)


@pytest.mark.parametrize("policy", ["sponge", "fa2", "static"])
def test_transcript_replay_matches_batch_run_fast(policy):
    """A transcript driven op by op through a ``FastSession`` == the
    batch run == the reference's fast session replay."""
    batch, jbatch = poisson_batches()
    ref = fast_runners(policy, prior_rps=20)[0].run(batch)
    mine = fast_runners(policy, prior_rps=20)[0].session()
    assert isinstance(mine, FastSession) and isinstance(mine,
                                                        SpongeSession)
    got = replay_transcript(mine, SessionTranscript.from_batch(batch),
                            batch)
    jax = jax_session.replay_transcript(
        fast_runners(policy, prior_rps=20)[1].session(),
        jax_session.SessionTranscript.from_batch(jbatch), jbatch)
    assert eq_sig(got) == eq_sig(ref) == eq_sig(jax)
    assert got.n_cancelled == 0


def _token_fast_runner(meta, jax=False):
    scaler_cls, runner_cls = ((JaxTokenSpongeScaler,
                               jax_fastpath.TokenFastSimRunner) if jax
                              else (TokenSpongeScaler, TokenFastSimRunner))
    scaler = scaler_cls(meta["cost"], c_set=DEFAULT_C, b_set=DEFAULT_B,
                        adaptation_interval=meta["tick"])
    return runner_cls(scaler, meta["cost"], DEFAULT_C, DEFAULT_B, c0=16,
                      tick=meta["tick"], prior_rps=meta["expected_rps"])


def test_transcript_replay_matches_batch_run_token():
    batch, meta = build_scenario("llm-chat", duration=40, seed=9)
    jbatch, jmeta = jax_scenarios.build_scenario("llm-chat", duration=40,
                                                 seed=9)
    ref = _token_fast_runner(meta).run(batch)
    sess = _token_fast_runner(meta).session()
    assert isinstance(sess, TokenFastSession)
    got = replay_transcript(sess, SessionTranscript.from_batch(batch),
                            batch)
    jax = jax_session.replay_transcript(
        _token_fast_runner(jmeta, jax=True).session(),
        jax_session.SessionTranscript.from_batch(jbatch), jbatch)
    assert eq_sig(got) == eq_sig(ref) == eq_sig(jax)
    assert got.tokens_served == ref.tokens_served == jax.tokens_served
    assert got.ttft_p99 == ref.ttft_p99 == jax.ttft_p99


@pytest.mark.parametrize("name", SESSION)
def test_exact_and_fast_sessions_agree_under_renegotiation(name):
    """With a live update/cancel stream the object-based and
    struct-of-arrays sessions stay decision-identical (quanta 0), and
    the fast session equals the reference's."""
    fast, fstats = run_scenario(name, engine="fast", duration=50, seed=13,
                                budget_quantum=0.0, lam_quantum=0.0)
    exact, estats = run_scenario(name, engine="exact", duration=50,
                                 seed=13)
    assert fstats["session"] == estats["session"]
    assert [(t, d.c, d.b) for t, d in fast.decisions] == \
        [(t, d.c, d.b) for t, d in exact.decisions]
    assert (fast.n_requests, fast.n_violations, fast.n_cancelled) == \
        (exact.n_requests, exact.n_violations, exact.n_cancelled)
    assert fast.buckets == exact.buckets
    jfast, jstats = jax_scenarios.run_scenario(
        name, engine="fast", duration=50, seed=13, budget_quantum=0.0,
        lam_quantum=0.0)
    assert eq_sig(fast) == eq_sig(jfast)
    assert (fstats["session"], fstats["solver"]) == \
        (jstats["session"], jstats["solver"])


@pytest.mark.parametrize("mid_flight", [True, False])
@pytest.mark.parametrize("name", SESSION)
def test_fast_session_scenario_equals_reference(name, mid_flight):
    """The default (quantized) fast session run: report, applied counts
    and solver stats equal the reference's."""
    rep, stats = run_scenario(name, duration=50, seed=13,
                              mid_flight=mid_flight)
    jrep, jstats = jax_scenarios.run_scenario(name, engine="fast",
                                              duration=50, seed=13,
                                              mid_flight=mid_flight)
    assert stats["engine"] == "fast"
    assert eq_sig(rep) == eq_sig(jrep)
    for k in ("session", "solver", "events"):
        assert stats[k] == jstats[k], k


def _fast_backlogged(runner):
    """``test_session.py``'s static 8-core slot with a 6-deep burst: the
    head dispatches at once (b = 1), the tail queues behind ~0.088 s
    service times."""
    sess = runner.session()
    return sess, [sess.submit(send=0.5, comm_latency=0.1, slo=5.0)
                  for _ in range(6)]


def test_fast_update_slo_changes_outcome_microcase():
    reports = []
    for runner in fast_runners("static", c_set=(8,), b_set=(1, 2, 4, 8),
                               c0=8):
        sess, hs = _fast_backlogged(runner)
        sess.step_until(0.7)
        assert sess.record(hs[-1])["status"] == "queued"
        assert sess.update_slo(hs[-1], deadline=0.71)
        rep = sess.finish(30.0)
        assert rep.n_requests == 6 and rep.n_violations == 1
        rec = sess.record(hs[-1])
        assert rec["status"] == "done" and rec["violated"] is True
        reports.append(rep)
    assert eq_sig(reports[0]) == eq_sig(reports[1])
    sess, _ = _fast_backlogged(fast_runners("static", c_set=(8,),
                                            b_set=(1, 2, 4, 8), c0=8)[0])
    assert sess.finish(30.0).n_violations == 0


@pytest.mark.parametrize("relax", [False, True])
def test_fast_relaxed_budget_avoids_violation(relax):
    """A hopeless deadline relaxed while queued completes clean."""
    reports = []
    for runner in fast_runners("static", c_set=(8,), b_set=(1, 2, 4, 8),
                               c0=8):
        sess = runner.session()
        hs = [sess.submit(send=0.5, comm_latency=0.1,
                          slo=5.0 if i < 5 else 0.25) for i in range(6)]
        sess.step_until(0.65)
        if relax:
            assert sess.record(hs[-1])["status"] == "queued"
            assert sess.update_slo(hs[-1], slo=5.0)
        reports.append(sess.finish(30.0))
    assert eq_sig(reports[0]) == eq_sig(reports[1])
    assert (reports[0].n_violations == 0) if relax \
        else (reports[0].n_violations >= 1)


def test_fast_cancelled_requests_leave_every_aggregate():
    reports = []
    for runner in fast_runners():
        sess = runner.session()
        handles = [sess.submit(send=3.0 + 0.01 * i, comm_latency=0.2,
                               slo=8.0) for i in range(20)]
        assert sess.cancel(handles[-1])
        sess.step_until(3.3)
        cancelled = [h for h in handles[:10] if sess.cancel(h)]
        assert cancelled, "some requests must still be queued at t=3.3"
        assert not sess.cancel(cancelled[0])
        assert not sess.update_slo(cancelled[0], slo=9.0)
        assert sess.record(cancelled[0])["status"] == "cancelled"
        rep = sess.finish(40.0)
        assert rep.n_cancelled == len(cancelled) + 1
        assert rep.n_requests == 20 - rep.n_cancelled
        assert rep.n_violations == 0
        reports.append(rep)
    assert eq_sig(reports[0]) == eq_sig(reports[1])


def test_pending_cancel_counted_uniformly_across_engines():
    """A cancel before arrival lands in n_cancelled on the column and
    object-based sessions alike."""
    exact = runners()[0].session()
    for sess in (fast_runners()[0].session(), exact):
        hs = [sess.submit(send=2.0 + 0.1 * i, comm_latency=0.1, slo=8.0)
              for i in range(5)]
        assert sess.cancel(hs[3])
        rep = sess.finish(30.0)
        assert rep.n_cancelled == 1 and rep.n_requests == 4


def test_fast_cancel_deflates_lambda_window():
    lams = []
    for runner in fast_runners():
        sess = runner.session()
        hs = [sess.submit(send=1.0 + 0.001 * i, comm_latency=0.5, slo=30.0)
              for i in range(50)]
        sess.step_until(1.6)
        before = sess._rate(1.6)
        assert sum(sess.cancel(h) for h in hs[:40]) > 0
        after = sess._rate(1.6)
        assert after < before
        lams.append((before, after))
    assert lams[0] == lams[1]


def test_token_session_renegotiation_scope():
    """Token sessions renegotiate TTFT only while a request waits for
    admission; once its prompt joins a decode step it is committed."""
    results = []
    for jax in (False, True):
        build = (jax_scenarios.build_scenario if jax else build_scenario)
        batch, meta = build("llm-chat", duration=30, seed=21)
        sess = _token_fast_runner(meta, jax=jax).session()
        handles = sess.submit_batch(batch)
        sess.step_until(float(batch.arrival[len(batch) // 2]))
        outcomes = {"applied": 0, "refused": 0}
        for h in handles:
            ok = sess.update_slo(h, deadline=float(batch.deadline[h]) + 0.2)
            outcomes["applied" if ok else "refused"] += 1
        assert outcomes["applied"] > 0 and outcomes["refused"] > 0
        rep = sess.finish()
        assert rep.tokens_served > 0 and rep.n_requests > 0
        results.append((outcomes, eq_sig(rep), rep.tokens_served,
                        rep.ttft_p99))
    assert results[0] == results[1]


def test_fast_session_guards():
    sess = fast_runners()[0].session()
    h = sess.submit(send=1.0, comm_latency=0.1, slo=1.0)
    assert sess.record(h)["status"] == "pending"
    with pytest.raises(ValueError):
        sess.step_until(float("inf"))
    sess.step_until(2.0)
    with pytest.raises(ValueError):
        sess.submit(send=0.5, comm_latency=0.1)
    assert not sess.cancel(12345678) and not sess.update_slo(12345678,
                                                             slo=2.0)
    batch, _ = poisson_batches(duration=10)
    with pytest.raises(ValueError, match="past"):
        sess.submit_batch(batch)


def test_fast_cancel_storm_scenario_end_to_end():
    rep, stats = run_scenario("cancel-storm", engine="fast", duration=80,
                              seed=5)
    assert rep.n_cancelled > 0
    assert stats["session"]["cancel"] == rep.n_cancelled
    plain, _ = run_scenario("cancel-storm", engine="fast", duration=80,
                            seed=5, mid_flight=False)
    assert plain.n_cancelled == 0
    assert rep.core_seconds <= plain.core_seconds + 1e-9


def test_fast_slo_renegotiation_changes_decisions_at_scale():
    """``test_session.py``'s acceptance case at a tenth of its 110k
    requests: renegotiated budgets move the fast engine's decisions."""
    ev, st_ev = run_scenario("slo-renegotiation", engine="fast",
                             requests=11_000, seed=11)
    plain, _ = run_scenario("slo-renegotiation", engine="fast",
                            requests=11_000, seed=11, mid_flight=False)
    assert ev.n_requests >= 10_000 and st_ev["session"]["update"] > 1_000
    d_ev = [(t, d.c, d.b) for t, d in ev.decisions]
    d_pl = [(t, d.c, d.b) for t, d in plain.decisions]
    assert len(d_ev) == len(d_pl)
    assert sum(a != b for a, b in zip(d_ev, d_pl)) > 0
