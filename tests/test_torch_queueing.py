"""The port's bulk EDF queue API, the small shared pieces and the fleet
session, against the JAX package's.

``FastEDFQueue.push_many`` / ``pop_ready`` / ``peek_deadline`` /
``drain`` / ``__contains__`` and ``EDFQueue.extend`` mirror the bulk
section of ``tests/test_queueing.py``; ``TokenCostModel.sample_profile``
/ ``tokens_per_second``, ``RequestBatch.total_tokens``,
``RunReport.get`` / ``keys`` / ``as_dict`` and
``VerticalScaledInstance.throughput`` / its ``weight_bytes`` penalty are
held to the reference's values; and ``FleetSession`` mirrors the fleet
legs of ``tests/test_session.py`` (transcript replay == batch run; a
tightened budget re-routes), each equal to the reference's session on
the same inputs.  Everything here runs on the CPU.
"""
import numpy as np
import pytest
from _hyp import given, settings, st  # guarded hypothesis import

from repro.core import queueing as jqueueing
from repro.core.cost_model import TokenCostModel as JTokenCostModel
from repro.core.perf_model import yolov5s_like as jyolov5s_like
from repro.core.slo import Request as JRequest
from repro.core.vertical import VerticalScaledInstance as JInstance
from repro.serving import fleet as jfleet
from repro.serving import scenarios as jax_scenarios
from repro.serving import session as jsession
from repro.serving.api import make_sim_server as jmake_sim_server
from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.queueing import DynamicBatcher, EDFQueue, FastEDFQueue
from repro_torch.core.slo import Request
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.core.vertical import VerticalScaledInstance
from repro_torch.serving.api import RunReport, make_sim_server
from repro_torch.serving.fleet import FleetFastSimRunner, FleetSpongeScaler
from repro_torch.serving.scenarios import build_scenario
from repro_torch.serving.session import (FleetSession, SessionTranscript,
                                         drive_session_events,
                                         replay_transcript)
from repro_torch.serving.workload import RequestBatch

PERF = yolov5s_like()
JPERF = jyolov5s_like()

bulk_dls = st.lists(st.floats(0.0, 100.0), min_size=0, max_size=60)


def _drain(q):
    out = []
    while len(q):
        out.extend(q.pop_batch(1))
    return out


# --------------------------------------------------------------------------
# bulk push_many / pop_ready: order-identical to sequential push / pop
# --------------------------------------------------------------------------
@given(bulk_dls, st.integers(1, 5))
@settings(deadline=None)
def test_push_many_order_identical_to_sequential(dls, n_chunks):
    """Chunked push_many (the sorted-block, heapify and sift paths) pops
    in exactly the sequential push order, and in the reference's."""
    seq, bulk, jbulk = FastEDFQueue(), FastEDFQueue(), \
        jqueueing.FastEDFQueue()
    for i, dl in enumerate(dls):
        seq.push(dl, i)
    idxs = np.arange(len(dls), dtype=np.int64)
    arr = np.asarray(dls, np.float64)
    for part_d, part_i in zip(np.array_split(arr, n_chunks),
                              np.array_split(idxs, n_chunks)):
        bulk.push_many(part_d, part_i)
        jbulk.push_many(part_d, part_i)
    assert bulk._heap == jbulk._heap
    assert len(bulk) == len(seq)
    assert _drain(bulk) == _drain(seq)


def test_push_many_sorted_block_fast_path():
    """An already-sorted block into an empty queue IS the heap."""
    q = FastEDFQueue()
    q.push_many([1.0, 2.0, 3.0, 3.0], [0, 1, 2, 3])
    assert q.peek_deadline() == 1.0
    assert 2 in q and 7 not in q
    assert _drain(q) == [0, 1, 2, 3]
    q.push_many([], [])
    assert len(q) == 0


@given(bulk_dls, st.integers(1, 8), st.floats(0.0, 120.0))
@settings(deadline=None)
def test_pop_ready_matches_model(dls, b, before):
    """pop_ready(b, before) = the ≤b earliest (deadline, idx) pairs
    with deadline strictly below the bound, removed from the queue."""
    q = FastEDFQueue()
    q.push_many(np.asarray(dls, np.float64),
                np.arange(len(dls), dtype=np.int64))
    model = sorted((dl, i) for i, dl in enumerate(dls))
    want = [i for dl, i in model if dl < before][:b]
    got = q.pop_ready(b, before=before)
    assert got == want
    assert len(q) == len(dls) - len(want)
    assert _drain(q) == [i for dl, i in model if (dl, i) not in
                         {(dls[j], j) for j in want}]


def test_pop_ready_exclusive_bound_and_empty():
    q = FastEDFQueue()
    assert q.pop_ready(4) == []
    q.push_many([2.0, 1.0, 3.0], [0, 1, 2])
    assert q.pop_ready(5, before=1.0) == []      # strict: dl < before
    assert q.pop_ready(5, before=2.0) == [1]
    assert q.pop_ready(5) == [0, 2]              # before=inf == pop_batch


def _renegotiate(q):
    """One sequence of bulk calls, re-keys and cancels; returns every
    pop it makes."""
    q.push_many([5.0, 6.0, 7.0, 8.0], [0, 1, 2, 3])
    assert q.update_deadline(3, 1.0)             # tighten: jumps the line
    assert q.cancel(1)
    q.push_many([6.5, 0.5], [4, 5])              # second block, non-empty heap
    first = q.pop_ready(2, before=5.0)
    assert q.update_deadline(0, 9.0)             # relax behind idx 2
    return first, _drain(q), q.pop_ready(3)


def test_bulk_ops_with_renegotiation_and_cancels():
    """Stale tuples from update_deadline/cancel between bulk calls are
    discarded, never served; re-keyed entries pop at their new rank —
    as in the reference's queue."""
    got = _renegotiate(FastEDFQueue())
    assert got == ([5, 3], [4, 2, 0], [])
    assert got == _renegotiate(jqueueing.FastEDFQueue())


def test_drain_returns_live_pairs_in_edf_order():
    """drain() pops every live entry as (deadline, index) in EDF order,
    skipping re-keyed and cancelled tuples (the fleet's re-route)."""
    for q in (FastEDFQueue(), jqueueing.FastEDFQueue()):
        q.push_many([4.0, 2.0, 3.0, 1.0], [0, 1, 2, 3])
        q.update_deadline(0, 0.5)
        q.cancel(2)
        assert q.drain() == [(0.5, 0), (1.0, 3), (2.0, 1)]
        assert len(q) == 0 and q.drain() == []


def test_edf_queue_extend_and_batcher():
    rng = np.random.default_rng(2)
    rs = [Request.make(arrival=float(a), comm_latency=float(c),
                       slo=float(s))
          for a, c, s in zip(rng.uniform(0, 5, 30), rng.uniform(0, 0.3, 30),
                             rng.uniform(0.5, 2.0, 30))]
    q = EDFQueue()
    q.extend(rs)
    assert len(q) == 30
    batcher = DynamicBatcher(q, 4)
    seen = []
    while batcher.has_work():
        batch = batcher.next_batch()
        assert 1 <= len(batch) <= 4
        seen.extend(r.deadline for r in batch)
    assert seen == sorted(seen) == sorted(r.deadline for r in rs)


# --------------------------------------------------------------------------
# the small shared pieces
# --------------------------------------------------------------------------
def test_token_cost_model_sample_profile_and_rate_equal_reference():
    cost = TokenCostModel.smollm_like()
    jcost = JTokenCostModel.smollm_like()
    args = ([16, 64, 256, 1024], [1, 2, 4, 8, 16], [1, 2, 4, 8, 16])
    pre, dec = cost.sample_profile(*args, noise=0.02, seed=5)
    assert (pre, dec) == jcost.sample_profile(*args, noise=0.02, seed=5)
    for c, slots in ((1, 1), (4, 8), (16, 16)):
        assert cost.tokens_per_second(c, slots) == \
            jcost.tokens_per_second(c, slots) > 0
    pre0, dec0 = cost.sample_profile(*args, noise=0.0)
    fit = TokenCostModel.fit(pre0, dec0, mean_prompt=cost.mean_prompt,
                             mean_decode=cost.mean_decode)
    assert fit.r2_prefill > 0.999 and fit.r2_decode > 0.999
    for c in (1, 4, 16):
        assert float(fit.prefill_latency(c, 200)) == pytest.approx(
            float(cost.prefill_latency(c, 200)), rel=1e-3)


def test_request_batch_total_tokens():
    rng = np.random.default_rng(3)
    send = np.sort(rng.uniform(0, 10, 50))
    batch = RequestBatch.from_send(
        send, np.full(50, 0.01), slo=1.0,
        prompt_tokens=rng.integers(8, 64, 50),
        decode_tokens=rng.integers(1, 32, 50))
    assert batch.total_tokens == int(batch.decode_tokens.sum()) + 50
    plain = RequestBatch.from_send(np.arange(5.0), np.full(5, 0.01),
                                   slo=1.0)
    assert plain.total_tokens == 5


def test_run_report_is_dict_like():
    script = [Request.make(arrival=0.1 * i, comm_latency=0.02, slo=1.0)
              for i in range(10)]
    jscript = [JRequest.make(arrival=0.1 * i, comm_latency=0.02, slo=1.0)
               for i in range(10)]
    report = make_sim_server(PERF, "sponge", prior_rps=10.0).run(
        script, horizon=4.0)
    jreport = jmake_sim_server(JPERF, "sponge", prior_rps=10.0).run(
        jscript, horizon=4.0)
    assert isinstance(report, RunReport)
    assert report["p99"] == report.p99 == report.get("p99")
    assert set(report.as_dict()) == set(report.keys())
    assert report.keys() == jreport.keys()
    assert report.get("nope", 123) == 123
    assert np.isnan(report.accuracy_goodput) and report.model_swaps == 0
    assert report.model_timeline is None


def test_vertical_instance_throughput_and_weight_penalty():
    for kw in ({}, {"weight_bytes": 2.0e9}, {"weight_bytes": 1.0e9,
                                            "ici_bw": 25e9}):
        inst = VerticalScaledInstance(DEFAULT_C, DEFAULT_B, PERF, c0=8,
                                      **kw)
        jinst = JInstance(DEFAULT_C, DEFAULT_B, JPERF, c0=8, **kw)
        assert inst.resize_penalty == jinst.resize_penalty
        assert inst.throughput() == jinst.throughput() > 0
        assert inst.resize(16, now=1.0) == jinst.resize(16, now=1.0)
        assert inst.throughput() == jinst.throughput()


# --------------------------------------------------------------------------
# the fleet session (the fleet legs of tests/test_session.py)
# --------------------------------------------------------------------------
def _fleet_runner(meta, mod=None, router=None):
    fl = jfleet if mod == "jax" else None
    scaler_cls = fl.FleetSpongeScaler if fl else FleetSpongeScaler
    runner_cls = fl.FleetFastSimRunner if fl else FleetFastSimRunner
    perf = JPERF if fl else PERF
    pol = scaler_cls(perf, c_set=DEFAULT_C, b_set=DEFAULT_B,
                     adaptation_interval=meta["tick"])
    kw = {} if router is None else {"router": router}
    return runner_cls(pol, perf, DEFAULT_C, DEFAULT_B, n0=meta["n0"],
                      c0=meta["c0"], tick=meta["tick"],
                      prior_rps=meta["expected_rps"], **kw)


def _sig(report):
    decisions = [(t, d.c, d.b, d.n, d.scale_up_delay, d.feasible)
                 for t, d in (report.decisions or [])]
    return (decisions, report.buckets, report.n_requests,
            report.n_violations, report.n_cancelled, report.core_seconds,
            report.p50, report.p99, report.core_timeline)


def test_transcript_replay_matches_batch_run_fleet():
    """A fleet session fed the workload's transcript replays the batch
    run exactly, and equals the reference's session."""
    batch, meta = build_scenario("replica-failure", duration=90, seed=5)
    events = meta["fleet_events"]
    ref = _fleet_runner(meta).run(batch, events=events)
    sess = _fleet_runner(meta).session(fleet_events=events)
    assert isinstance(sess, FleetSession)
    got = replay_transcript(sess, SessionTranscript.from_batch(batch),
                            batch)
    jsess = _fleet_runner(meta, "jax").session(fleet_events=events)
    jgot = jsession.replay_transcript(
        jsess, jsession.SessionTranscript.from_batch(batch), batch)
    assert _sig(got) == _sig(ref) == _sig(jgot)
    assert sess.events_processed == jsess.events_processed


def test_fleet_session_tighten_reroutes_and_runs():
    """Tightening queued budgets on a fleet re-offers them to the router;
    the run completes consistently (none lost), with the reference's
    applied counts and decisions."""
    batch, meta = build_scenario("fleet-flash-crowd", duration=60, seed=3)
    rng = np.random.default_rng(0)
    pick = rng.choice(len(batch), size=len(batch) // 5, replace=False)
    events = sorted((float(batch.arrival[i]) + 0.05, "update", int(i),
                     float(batch.deadline[i]) - 0.3) for i in pick)
    cancels = sorted((float(batch.arrival[i]) + 0.02, "cancel", int(i))
                     for i in pick[:40])
    events = sorted(events + cancels)
    out = []
    for mod, drive in ((None, drive_session_events),
                       ("jax", jsession.drive_session_events)):
        runner = _fleet_runner(meta, mod, router="edf-deadline")
        sess = runner.session()
        handles = sess.submit_batch(batch)
        applied = drive(sess, handles, events)
        rep = sess.finish()
        for rep_ in runner.replicas:
            assert len(rep_.dls) == len(rep_.queue)
        out.append((applied, _sig(rep), sess.events_processed))
    (applied, sig, ev), (japplied, jsig, jev) = out
    assert applied["update"] > 0 and applied["cancel"] > 0
    assert sig[2] + sig[4] <= len(batch) and sig[2] > 0
    assert (applied, sig, ev) == (japplied, jsig, jev)


def test_fleet_scenario_build_equals_reference_columns():
    """The three fleet builds give the reference's columns (the session
    tests above replay them)."""
    for name in ("replica-failure", "rolling-restart", "fleet-flash-crowd"):
        batch, _ = build_scenario(name, duration=30, seed=9)
        jbatch, _ = jax_scenarios.build_scenario(name, duration=30, seed=9)
        for col in ("send", "arrival", "comm_latency", "deadline", "slo",
                    "size_kb"):
            np.testing.assert_array_equal(getattr(batch, col),
                                          getattr(jbatch, col))
