"""The serving path's own spans and marks (``repro_torch.serving.trace``)
on the CPU: a dozen llm-chat requests on the reduced smollm-135m, served
on the modelled clock with a fixed cost model so that two runs agree
exactly.  Tracing on changes nothing that is served; off, nothing is
recorded and the profiler's ``record_function`` is never entered; the
records agree with the runner's ``bucket_log`` and the step tables'
``calls``; under ``torch.profiler`` the spans nest as the calls do.
"""
import dataclasses

import torch

from repro_torch.core.cost_model import TokenCostModel
from repro_torch.serving import api, scenarios
from repro_torch.serving import token_backend as tb
from repro_torch.serving import trace as trace_mod
from repro_torch.serving.trace import ServeTrace

ARCH = "smollm-135m-reduced"
PL, MD = 8, 3


def _serve(trace, cost=TokenCostModel.smollm_like()):
    """Build the stack (``cost`` None: calibrated) and serve the requests;
    returns the runner, the backend, the report and the arrivals."""
    runner, backend, cfg, _ = tb.make_token_live_server(
        ARCH, c_set=(1, 2), b_set=(1, 2, 4), prompt_len=PL, max_decode=MD,
        clock="modeled", tick=0.25, prior_rps=40.0, cost=cost,
        device="cpu", trace=trace)
    batch, _ = scenarios.build_scenario("llm-chat", requests=14, seed=5,
                                        rps=40.0)
    arrivals = tb.scenario_arrivals(batch, 14, 5, PL, MD, cfg.vocab_size)
    return runner, backend, runner.run(arrivals), arrivals


def _decisions(report):
    out = []
    for t, d in report.decisions:
        d = dataclasses.asdict(d)
        d.pop("solver_time")
        out.append((t, d))
    return out


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    for mod in (trace_mod, torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function", refuse)


def test_tracing_changes_nothing_served(monkeypatch):
    """Ids, decisions and buckets with the trace on equal those with it
    off; off, no object records and ``record_function`` is never entered
    (nor is it on, while no profiler records)."""
    _no_record_function(monkeypatch)
    made = []
    monkeypatch.setattr(ServeTrace, "__init__",
                        lambda self: made.append(self))
    runner, backend, off, arrivals = _serve(None)
    assert made == []
    steps = [fn.step for fn in backend.pre_table.fns.values()]
    assert runner.trace is backend.trace is None
    assert backend.pre_table.trace is backend.dec_table.trace is None
    assert all(s.trace is None for s in steps)
    monkeypatch.undo()
    _no_record_function(monkeypatch)
    tr = ServeTrace()
    _, traced, on, again = _serve(tr)
    assert tr.records
    assert [traced.generated[r.id] for r, _ in again] == \
        [backend.generated[r.id] for r, _ in arrivals]
    assert _decisions(on) == _decisions(off) and off.decisions
    assert on.buckets == off.buckets and len(off.buckets) > 1
    assert max(b for _, _, b, _ in off.buckets) > 1
    assert len(off.buckets) < len(arrivals)


def test_records_match_the_bucket_log_and_the_calls():
    tr = ServeTrace()
    runner, backend, report, arrivals = _serve(tr, cost=None)
    gangs = tr.named("gang")
    assert len(gangs) == len(report.buckets)
    index = {id(r): i for i, r in enumerate(tr.records)}
    served = []
    for k, (g, (_, c, b, n)) in enumerate(zip(gangs, report.buckets)):
        assert g.attrs["gang"] == k and g.parent is None
        assert (g.attrs["c"], g.attrs["b"], len(g.attrs["reqs"])) == (c, b, n)
        served += g.attrs["reqs"]
    assert sorted(served) == sorted(r.id for r, _ in arrivals)

    admitted = {m.attrs["req"]: m.start for m in tr.named("admit")}
    gang_of = {}
    for g in gangs:
        for rid in g.attrs["reqs"]:
            assert admitted[rid] <= g.start
            gang_of[rid] = g.attrs["gang"]
    for name in ("first_token", "finish"):
        marks = tr.named(name)
        assert sorted(m.attrs["req"] for m in marks) == sorted(served)
        for m in marks:
            g = gangs[m.attrs["gang"]]
            assert gang_of[m.attrs["req"]] == m.attrs["gang"]
            assert m.parent == index[id(g)] and g.start <= m.start <= g.end

    for name, table in (("prefill", backend.pre_table),
                        ("decode", backend.dec_table)):
        spans = tr.named(name)
        assert len(spans) == len(table.calls) > 0
        for i, (s, (t0, c, b, dt)) in enumerate(zip(spans, table.calls)):
            g = gangs[s.attrs["gang"]]
            assert s.attrs["step"] == i and s.parent == index[id(g)]
            assert (g.attrs["c"], g.attrs["b"]) == (c, b)
            assert t0 <= s.start * 1e-9 <= s.end * 1e-9 <= t0 + dt
            sync = [r for r in tr.records[index[id(s)] + 1:]
                    if r.parent == index[id(s)]]
            assert [r.name for r in sync][-1] == "sponge.sync"
    per_gang = [sum(s.attrs["gang"] == g.attrs["gang"]
                    for s in tr.named("decode")) for g in gangs]
    assert per_gang == [min(max(r.decode_tokens for r, _ in arrivals
                                if r.id in g.attrs["reqs"]), MD)
                        for g in gangs]

    decides = tr.named("decide")
    assert [(d.attrs["c"], d.attrs["b"]) for d in decides] == [
        api.resolve_decision(backend.c_set, dec)
        for _, dec in report.decisions]
    for name in ("setup.capture", "setup.calibrate"):
        (s,) = tr.named(name)
        assert s.end < gangs[0].start
    assert all(r.end is not None and r.end >= r.start for r in tr.records)
    assert all(r.name.startswith("sponge.") for r in tr.records)


def test_spans_nest_on_the_profilers_timeline():
    tr = ServeTrace()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(tr)
    events = [e for e in prof.events() if e.name.startswith("sponge.")]
    by = {}
    for e in events:
        by.setdefault(e.name, []).append((e.time_range.start,
                                          e.time_range.end))
    for name in ("gang", "prefill", "decode", "sync", "copy_in",
                 "ids_to_host", "decide"):
        assert len(by["sponge." + name]) == len(tr.named(name)), name

    def inside(inner, outer):
        return [any(a <= s and e <= b for a, b in by[outer])
                for s, e in by[inner]]

    assert all(inside("sponge.decode", "sponge.gang"))
    assert all(inside("sponge.prefill", "sponge.gang"))
    in_decode = inside("sponge.sync", "sponge.decode")
    assert any(in_decode)
    assert all(d or p for d, p in zip(in_decode,
                                      inside("sponge.sync", "sponge.prefill")))
