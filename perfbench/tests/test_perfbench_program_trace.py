"""The program's spans read beside a traced run (``harness/program.py``):
the arithmetic of the queue holds and of the step calls' idle split on
synthetic records, and tiny traced runs on the CPU in which the
program's gangs agree with the harness's, the profiler's stall stays
out of the holds, and a program without the trace module is read as
before."""
import statistics
import sys
import time

import pytest

import perfbench_tiny
from perfbench.harness import measure, program, spec, trace
from repro_torch.serving.trace import Record

MS = 1_000_000


def _gang(k, start, end, reqs):
    return Record("sponge.gang", start * MS, end * MS, None,
                  {"gang": k, "c": 1, "b": len(reqs), "reqs": reqs})


def _admit(req, t):
    return Record("sponge.admit", t * MS, t * MS, None, {"req": req})


def test_queue_holds_leave_out_other_gangs_and_the_profiler():
    records = [_admit(1, 0), _admit(2, 5), _gang(0, 10, 100, [1]),
               _admit(3, 120), _gang(1, 200, 300, [2, 3]), _admit(4, 250),
               _gang(2, 300, 400, [4]), _admit(5, 450),
               _gang(3, 500, 600, [5])]
    holds = [(130 * MS, 160 * MS)]
    got = program.queue_holds(records, [True, True, True, False], holds)
    # 1: 10 ms; 2: 195 less gang 0's 90 and the hold's 30; 3: 80 less
    # the hold; 4: 50 all inside gang 1; 5: dispatched after the window
    assert got == pytest.approx([0.010, 0.075, 0.050, 0.0])
    assert program.program_metrics(
        _Run([True, True, True, False]), records, holds)[
            "queue_hold_p90_s"] == pytest.approx(0.0675)


class _Run:
    def __init__(self, in_window):
        self.gangs = in_window
        self.trace = None

    def in_window(self, g):
        return g


def test_idle_split_adds_up_to_the_step_calls_idle_share():
    busy = [(2, 4), (6, 8), (25, 35)]
    steps = [(0, 10), (20, 30), (40, 50)]
    inner, edges, total = program.step_idle_split(busy, steps)
    # step 1: idle 4-6 inside, 0-2 and 8-10 at the edges; step 2: busy
    # from 25 to its end; step 3: no operation at all
    assert (inner, edges, total) == (2, 4 + 5 + 10, 30)
    assert inner + edges == total - trace._overlap(busy, steps)


def test_idle_gaps_name_the_innermost_program_span():
    spans = [(0, 100, "harness.step_until"), (0, 90, "program.execute"),
             (0, 90, "sponge.gang"), (10, 60, "program.decode"),
             (12, 58, "sponge.decode"), (40, 58, "sponge.sync"),
             (60, 70, "sponge.ids_to_host")]
    busy = [(0, 20), (30, 45), (50, 62), (68, 95)]
    gaps = program.label_gaps(busy, spans)
    assert gaps == {"sponge.decode": pytest.approx(10e-9),
                    "sponge.sync": pytest.approx(5e-9),
                    "sponge.ids_to_host": pytest.approx(6e-9),
                    "harness.step_until": pytest.approx(5e-9)}


def _run(tmp_path, seed, seconds):
    root = perfbench_tiny.make_root(tmp_path)
    bench = spec.load_benchmark(root)
    cell = spec.find(bench["workloads"], "danube-chat-sat", "workload")
    with program.Wiring() as w:
        result, _ = measure.run(bench, cell, seed, seconds, True,
                                time.perf_counter(), device="cpu", root=root)
    assert result["correct"]
    old = {}
    for m in spec.cell_metrics(bench, cell["name"], True):
        value = spec.metric_reader(m["name"], root)(w.run)
        if value is not None:
            old[m["name"]] = value
    return w, result, old


def test_the_programs_gangs_agree_with_the_harness_through_a_stall(
        tmp_path, monkeypatch):
    """The profiler's collection stalled for 8 s inside the window: the
    program's gangs are the harness's, and no request counts the stall
    as a hold."""
    stall = 8.0
    due, pause = trace.Tracer.due, trace.Tracer.pause

    def early_due(self, now, start, length):     # a slice at 0.3-0.6 s
        return due(self, now, 0.3, 0.3)

    def slow_pause(self):
        pause(self)
        time.sleep(stall)
        self.t_collect = time.perf_counter() - self.t1

    monkeypatch.setattr(trace.Tracer, "due", early_due)
    monkeypatch.setattr(trace.Tracer, "pause", slow_pause)
    w, result, old = _run(tmp_path, 2**31 + 91, 3.0)
    run, records = w.run, w.trace.records
    assert result["generator"]["trace_collect_s"] >= stall

    metrics = result["metrics"]
    assert old and set(metrics) - set(program.UNITS) == set(old)
    assert 0.0 <= metrics["queue_hold_p90_s"]["value"] < stall / 2
    held = program.queue_holds(records, [run.in_window(g) for g in run.gangs],
                               w.tracer.holds())
    assert max(held) < stall / 2
    # no device operation on the CPU: nothing to split
    assert "step_idle_in_graph" not in metrics
    for name in ("setup_capture_s", "setup_calibrate_s"):
        assert 0.0 < metrics[name]["value"] < run.setup_s

    gangs = [r for r in records if r.name == "sponge.gang"]
    assert len(gangs) == len(run.gangs) > 2
    first = {r.attrs["req"]: r.start * 1e-9 for r in records
             if r.name == "sponge.first_token"}
    base = min(rid for g in gangs for rid in g.attrs["reqs"])
    late, after = [], []
    eps = 1e-6
    for g, h, (t0, _, _, dt) in zip(gangs, run.gangs, w.prefill_calls,
                                    strict=True):
        assert g.attrs["b"] == h.b
        assert [rid - base for rid in g.attrs["reqs"]] == h.reqs
        t_open = t0 - h.prefill[0]      # the window's clock at this gang
        dispatch, start = h.dispatch + t_open, g.start * 1e-9
        # the gang opens between the harness's dispatch and the prefill
        assert dispatch - eps <= start <= t0 + eps
        late.append(start - dispatch)
        # a first token is marked after the prefill call, before the
        # gang's next step
        nxt = h.decode[0][0] + t_open if h.decode else g.end * 1e-9
        for rid, i in zip(g.attrs["reqs"], h.reqs):
            assert run.tokens[i][0] + t_open - eps <= first[rid] <= nxt + eps
            after.append(first[rid] - (t0 + dt))
    # a loaded CPU can delay a single reading by milliseconds; the
    # typical one agrees within 1 ms
    assert statistics.median(late) < 1e-3
    assert statistics.median(after) < 1e-3


def test_a_program_without_the_trace_module_is_read_as_before(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.serving.trace", None)
    w, result, old = _run(tmp_path, 2**31 + 92, 1.0)
    assert w.trace is None
    assert old and set(result["metrics"]) == set(old)
    assert "batch_fill" in old and "decode_step_ms" in old
    assert result["breakdown"]["idle_gaps"] == w.run.trace["idle_gaps"]
