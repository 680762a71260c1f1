"""The device trace of a ``--trace 1`` run, and the harness's host spans.

The harness opens spans around its own calls into the program
(``harness.step_until``, ``harness.sleep``, ``program.execute`` around a
gang, ``program.prefill`` / ``program.decode`` around one step call,
which ends after the call has waited for the device).  ``torch.profiler``
records them beside every device operation, on one clock, for a slice
of the window (``Tracer.due``, called only between two calls into the
session, so the slice holds whole gangs).  The profiler's start and its
collection at the slice's close hold the loop for seconds; ``due``
returns how long, and the window's clock leaves that time out, so no
request waits through it.  ``digest``
reduces the trace to plain numbers and lists:

- ``busy_s``: the union of the device operations' intervals;
  ``window_s``: the slice's length on the host clock;
- ``kernel_s``: device seconds by operation name;
- ``step_busy_s`` / ``step_wall_s``: device-busy time inside the step
  calls' spans, and those spans' total;
- ``device_ops``: the ten operations that took most device time;
  ``idle_gaps``: device idle time inside the slice by the innermost
  host span it fell in (``host.other`` outside every span), the ten
  largest.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPAN_PREFIXES = ("harness.", "program.")
STEP_SPANS = ("program.prefill", "program.decode")


def span(name: str, on: bool):
    """A host span recorded by the profiler (nothing when ``on`` is off)."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class Tracer:
    """Records the slice that ``due`` opens and closes.  The profiler's
    device tracing is loaded once before the window (the first start in
    a process takes seconds), and only the slice's activity is recorded
    and collected."""

    ACTIVITIES = ("CPU", "CUDA")

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.results = None
        self.t_start = self.t_collect = 0.0
        if enabled:
            with self._profile():
                pass

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[getattr(ProfilerActivity, a)
                                   for a in self.ACTIVITIES])

    @property
    def active(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def due(self, now: float, start: float, length: float) -> float:
        """Open the slice once ``now`` reaches ``start``; close it once it
        has lasted ``length`` seconds.  Returns the seconds that opening
        or closing it held the caller (0 when it did neither)."""
        if not self.enabled:
            return 0.0
        if self.t0 is None and now >= start:
            begin = time.perf_counter()
            self.prof = self._profile()
            self.prof.prepare_trace()
            self.prof.start_trace()
            self.t0 = time.perf_counter()
            self.t_start = self.t0 - begin
            return self.t_start
        if self.active and time.perf_counter() - self.t0 >= length:
            self.pause()
            return self.t_collect
        return 0.0

    def pause(self) -> None:
        """Close the slice.  The recorded activity is collected at once
        (a C++ call); its digest into numbers waits for ``digest``, after
        the window and its drain."""
        from torch.autograd.profiler import _disable_profiler
        self.t1 = time.perf_counter()
        self.results = _disable_profiler()
        self.t_collect = time.perf_counter() - self.t1

    def digest(self) -> Optional[dict]:
        if self.t0 is None:
            return None
        if self.active:
            self.pause()
        t = time.perf_counter()
        device, spans = [], []
        for e in self.results.events():
            name = e.name()
            if e.is_user_annotation() or name.startswith(SPAN_PREFIXES):
                if str(e.device_type()).endswith("CPU") and \
                        name.startswith(SPAN_PREFIXES):
                    spans.append((e.start_ns(), e.end_ns(), name))
                continue
            if str(e.device_type()).endswith("CUDA"):
                device.append((e.start_ns(), e.end_ns(), name))
        out = reduce_trace(device, spans, self.t1 - self.t0)
        out["read_s"] = time.perf_counter() - t
        out["start_s"] = self.t_start
        out["collect_s"] = self.t_collect
        out["operations"] = len(device)
        return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = tot = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        tot += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


# the harness's spans from the innermost out: each kind never overlaps
# itself, and an inner kind lies inside an outer one
NESTING = ("program.prefill", "program.decode", "program.execute",
           "harness.sleep", "harness.step_until")


class _Labels:
    """The innermost host span at a time."""

    def __init__(self, spans):
        self.by = {k: sorted((a, b) for a, b, n in spans if n == k)
                   for k in NESTING}
        self.starts = {k: [a for a, _ in v] for k, v in self.by.items()}

    def at(self, t: int) -> str:
        for k in NESTING:
            i = bisect.bisect_right(self.starts[k], t) - 1
            if i >= 0 and self.by[k][i][1] >= t:
                return k
        return "host.other"


def reduce_trace(device: List[tuple], spans: List[tuple],
                 window_s: float) -> dict:
    """``device``: (start_ns, end_ns, name) of every device operation;
    ``spans``: (start_ns, end_ns, name) of the host spans."""
    busy = _union([(a, b) for a, b, _ in device])
    kernel: Dict[str, float] = defaultdict(float)
    for a, b, name in device:
        kernel[name] += (b - a) * 1e-9
    steps = _union([(a, b) for a, b, n in spans if n in STEP_SPANS])
    gaps: Dict[str, float] = defaultdict(float)
    if busy:
        lo = min([a for a, _, _ in spans] + [busy[0][0]])
        hi = max([b for _, b, _ in spans] + [busy[-1][1]])
        edges = [(lo, busy[0][0])] + [(busy[k][1], busy[k + 1][0])
                                      for k in range(len(busy) - 1)] + \
            [(busy[-1][1], hi)]
        labels = _Labels(spans)
        for a, b in edges:
            if b > a:
                gaps[labels.at((a + b) // 2)] += (b - a) * 1e-9
    top = sorted(kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9,
            "window_s": window_s,
            "kernel_s": dict(kernel),
            "step_busy_s": _overlap(busy, steps) * 1e-9,
            "step_wall_s": sum(b - a for a, b in steps) * 1e-9,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}
