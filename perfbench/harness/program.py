"""The port's own spans and marks (``repro_torch.serving.trace``) beside a
traced run, and the quantities they give.

The harness builds the serving stack without a trace and keeps only its
own spans from the profiler (``serve.py``, ``trace.py``).  ``Wiring``
supplies both from outside for the runs made inside it: the stack is
built with a ``ServeTrace``, the profiler's digest also keeps the
``sponge.*`` spans (innermost first in ``NESTING``, so that the device's
idle gaps name what the program was doing), and the metrics read from
the run gain the program's:

- ``queue_hold_p90_s``: for each request whose gang was dispatched in
  the window, its ``sponge.admit`` mark to the start of its
  ``sponge.gang`` span, less the time inside other gangs and inside the
  profiler's holds of the loop: the time it was held while no gang ran.
  90th percentile.
- ``step_idle_in_graph`` / ``step_idle_at_edges``: over the slice's
  ``sponge.prefill`` / ``sponge.decode`` spans, the device-idle time
  between each call's first and last device operation, and before the
  first and after the last (all of a call that ran none), as shares of
  the spans' total length.  The two add up to the idle share of those
  spans.
- ``setup_capture_s`` / ``setup_calibrate_s``: the lengths of the
  ``sponge.setup.capture`` and ``sponge.setup.calibrate`` spans.

Against a program without ``repro_torch.serving.trace`` the runs are the
harness's own and none of these is reported.  ``program_trace.py`` runs
a cell this way.
"""
from __future__ import annotations

import bisect
import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.harness import measure, serve, stats
from perfbench.harness import trace as htrace

PREFIX = "sponge."
STEPS = ("sponge.prefill", "sponge.decode")
# innermost first: the program's spans lie inside the harness's
# ``program.*`` spans, the step calls' inside ``program.prefill`` /
# ``program.decode``, the gang inside ``program.execute``
NESTING = ("sponge.sync", "sponge.replay", "sponge.copy_in", "sponge.prefill",
           "sponge.decode", "program.prefill", "program.decode",
           "sponge.ids_to_host", "sponge.decide", "sponge.gang",
           "program.execute", "harness.sleep", "harness.step_until")

UNITS = {"queue_hold_p90_s": "s", "step_idle_in_graph": "%",
         "step_idle_at_edges": "%", "setup_capture_s": "s",
         "setup_calibrate_s": "s"}


def label_gaps(busy: List[Tuple[int, int]],
               spans: List[tuple]) -> Dict[str, float]:
    """Device-idle seconds by the innermost host span around each gap's
    midpoint (``trace.reduce_trace``'s rule over ``NESTING``)."""
    by = {k: sorted((a, b) for a, b, n in spans if n == k) for k in NESTING}
    starts = {k: [a for a, _ in v] for k, v in by.items()}

    def at(t):
        for k in NESTING:
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and by[k][i][1] >= t:
                return k
        return "host.other"

    gaps: Dict[str, float] = defaultdict(float)
    if busy:
        lo = min([a for a, _, _ in spans] + [busy[0][0]])
        hi = max([b for _, b, _ in spans] + [busy[-1][1]])
        edges = [(lo, busy[0][0])] + [(busy[k][1], busy[k + 1][0])
                                      for k in range(len(busy) - 1)] + \
            [(busy[-1][1], hi)]
        for a, b in edges:
            if b > a:
                gaps[at((a + b) // 2)] += (b - a) * 1e-9
    return gaps


def step_idle_split(busy: List[Tuple[int, int]],
                    steps: List[Tuple[int, int]]) -> Tuple[int, int, int]:
    """``(in_graph, at_edges, total)`` nanoseconds over the step spans
    ``steps``; ``busy`` is the sorted, disjoint union of the device
    operations."""
    ends = [b for _, b in busy]
    inner = edges = total = 0
    for a, b in steps:
        total += b - a
        i = bisect.bisect_right(ends, a)
        first = last = None
        covered = 0
        while i < len(busy) and busy[i][0] < b:
            s, e = max(busy[i][0], a), min(busy[i][1], b)
            first = s if first is None else first
            last, covered = e, covered + e - s
            i += 1
        if first is None:
            edges += b - a
        else:
            edges += (first - a) + (b - last)
            inner += (last - first) - covered
    return inner, edges, total


class ProgramTracer(htrace.Tracer):
    """The harness's ``Tracer``, whose digest also keeps the program's
    spans: ``idle_gaps`` labelled over ``NESTING`` and the step calls'
    idle split under ``step_idle_ns``; every other key as before."""

    def digest(self) -> Optional[dict]:
        if self.t0 is None:
            return None
        if self.active:
            self.pause()
        t = time.perf_counter()
        device, spans, program = [], [], []
        for e in self.results.events():
            name = e.name()
            if e.is_user_annotation() or name.startswith(
                    htrace.SPAN_PREFIXES):
                if str(e.device_type()).endswith("CPU"):
                    if name.startswith(htrace.SPAN_PREFIXES):
                        spans.append((e.start_ns(), e.end_ns(), name))
                    elif name.startswith(PREFIX):
                        program.append((e.start_ns(), e.end_ns(), name))
                continue
            if str(e.device_type()).endswith("CUDA"):
                device.append((e.start_ns(), e.end_ns(), name))
        out = htrace.reduce_trace(device, spans, self.t1 - self.t0)
        busy = htrace._union([(a, b) for a, b, _ in device])
        gaps = label_gaps(busy, spans + program)
        out["idle_gaps"] = [[n, s] for n, s in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:10]]
        steps = sorted((a, b) for a, b, n in program if n in STEPS)
        out["step_idle_ns"] = step_idle_split(busy, steps) \
            if steps and busy else None
        out["read_s"] = time.perf_counter() - t
        out["start_s"] = self.t_start
        out["collect_s"] = self.t_collect
        out["operations"] = len(device)
        return out

    def holds(self) -> List[Tuple[int, int]]:
        """The intervals (perf-counter ns) in which starting and collecting
        the profiler held the loop."""
        out = []
        if self.t0 is not None:
            out.append((self.t0 - self.t_start, self.t0))
        if self.t1 is not None:
            out.append((self.t1, self.t1 + self.t_collect))
        return [(int(a * 1e9), int(b * 1e9)) for a, b in out]


def _inside(a: int, b: int, intervals: List[Tuple[int, int]]) -> int:
    return sum(max(0, min(b, y) - max(a, x)) for x, y in intervals)


def queue_holds(records, in_window: List[bool],
                holds: List[Tuple[int, int]]) -> List[float]:
    """Seconds each request of a gang dispatched in the window was held
    while no gang ran (module docstring).  ``records``: the program's
    trace records; ``in_window``: per ``sponge.gang`` span, in order,
    whether its gang was dispatched in the window; ``holds``: the
    profiler's holds."""
    admit = {r.attrs["req"]: r.start for r in records
             if r.name == PREFIX + "admit"}
    gangs = [r for r in records if r.name == PREFIX + "gang"]
    spans = [(g.start, g.end) for g in gangs]
    out = []
    for g, counted in zip(gangs, in_window, strict=True):
        if not counted:
            continue
        for rid in g.attrs["reqs"]:
            a = admit[rid]
            held = g.start - a - _inside(a, g.start, spans) \
                - _inside(a, g.start, holds)
            out.append(held * 1e-9)
    return out


def setup_span_s(records, name: str) -> Optional[float]:
    for r in records:
        if r.name == PREFIX + name:
            return (r.end - r.start) * 1e-9
    return None


def program_metrics(run, records, holds) -> Dict[str, Optional[float]]:
    """The program's quantities of a run (None where nothing was read)."""
    out: Dict[str, Optional[float]] = dict.fromkeys(UNITS)
    if records is not None:
        out["queue_hold_p90_s"] = stats.percentile(queue_holds(
            records, [run.in_window(g) for g in run.gangs], holds), 90)
        out["setup_capture_s"] = setup_span_s(records, "setup.capture")
        out["setup_calibrate_s"] = setup_span_s(records, "setup.calibrate")
    split = (run.trace or {}).get("step_idle_ns")
    if split and split[2] > 0:
        out["step_idle_in_graph"] = 100.0 * split[0] / split[2]
        out["step_idle_at_edges"] = 100.0 * split[1] / split[2]
    return out


def decode_walls_ms(run) -> Dict[str, Optional[float]]:
    """Median decode call wall of the gangs inside the profiled slice, and
    of the window's gangs outside it."""
    inside = [dt for g in stats.traced_gangs(run) for _, dt in g.decode]
    outside = [dt for g in stats.window_gangs(run) if not g.traced
               for _, dt in g.decode]
    return {k: 1e3 * statistics.median(v) if v else None
            for k, v in (("in_slice", inside), ("outside", outside))}


class Wiring:
    """Inside it, runs of ``measure.run`` build the stack with the
    program's trace (when the program has one and ``program`` is on),
    profile with :class:`ProgramTracer`, and report the program's metrics
    beside the harness's.  ``trace``, ``tracer``, ``run`` and
    ``prefill_calls`` (the prefill table's ``calls``) hold the last
    run's."""

    def __init__(self, program: bool = True):
        self.program = program
        self.trace = self.tracer = self.run = self.prefill_calls = None

    def __enter__(self) -> "Wiring":
        from repro_torch.serving import token_backend
        try:
            from repro_torch.serving.trace import ServeTrace
        except ImportError:
            ServeTrace = None
        wiring = self
        make, read = token_backend.make_token_live_server, \
            measure.read_metrics

        class Tracer(ProgramTracer):
            def __init__(self, enabled):
                super().__init__(enabled)
                wiring.tracer = self

        def make_traced(*args, **kw):
            wiring.trace = ServeTrace()
            stack = make(*args, trace=wiring.trace, **kw)
            wiring.prefill_calls = stack[1].pre_table.calls
            return stack

        def read_metrics(bench, run, trace, root=measure.spec.ROOT):
            out = read(bench, run, trace, root)
            wiring.run = run
            if trace:
                found = program_metrics(
                    run, None if wiring.trace is None
                    else wiring.trace.records, wiring.tracer.holds())
                out.update({k: {"value": float(v), "unit": UNITS[k]}
                            for k, v in found.items() if v is not None})
            return out

        self._saved = [(serve, "Tracer", serve.Tracer),
                       (measure, "read_metrics", read)]
        serve.Tracer, measure.read_metrics = Tracer, read_metrics
        if ServeTrace is not None and self.program:
            self._saved.append((token_backend, "make_token_live_server",
                                make))
            token_backend.make_token_live_server = make_traced
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, value in self._saved:
            setattr(mod, name, value)
