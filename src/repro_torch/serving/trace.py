"""Spans and marks inside the port's serving path: ``ServeTrace``.

Tracing is off unless an operator asks for it.  Off, no trace object
exists: every instrumented object holds ``trace = None`` and each
instrumented call site pays one ``is not None`` test.  To turn it on,
hand a trace to the stack as it is built,
``make_token_live_server(..., trace=ServeTrace())``; the runner, the
backend, both step tables and every captured step then record into it.

There are two ways to read it.  ``trace.records`` holds every span and
mark in the order it opened, each a :class:`Record` with its name, its
start and end on ``time.perf_counter_ns()`` (the clock of
``TimedExecutor.calls``), the index of the span it opened inside, and
its attributes.  And while a ``torch.profiler`` is recording, each span
also opens ``torch.profiler.record_function`` under its name, so it
lands on the profiler's timeline beside the device operations it
launched.  There is no exporter of its own.

Every name starts with ``sponge.``:

============================  ==========================================
``setup.capture``             ``make_token_live_server``: the warm-up
                              that captures every ``b``'s two steps
``setup.calibrate``           ``make_token_live_server``: the timing of
                              every ``(c, b)`` entry for the cost model
``admit`` (mark)              ``ExactSession.step_until``: a pending
                              request enters the runner's EDF queue
                              (``req``)
``decide``                    ``ScenarioRunner.drive``: the policy's
                              ``decide`` (``c``, ``b`` as applied)
``gang``                      ``TokenTorchBackend.execute``: one gang,
                              the whole call (``gang``, ``c``, ``b``,
                              ``reqs``)
``first_token``, ``finish``   ``execute``: after the step call that gave
(marks)                       a request its first or last token
                              (``req``, ``gang``)
``ids_to_host``               ``execute``: a step's ids copied to the
                              host
``prefill``, ``decode``       ``TimedExecutor.__call__``: one step call
                              until the device has finished (``gang``,
                              ``step``: the call's index in the table's
                              ``calls``)
``sync``                      ``TimedExecutor.__call__``: the wait for
                              the device
``copy_in``, ``replay``       ``CapturedStep.__call__``: the inputs'
                              copy into the static tensors, the graph's
                              replay
============================  ==========================================

A trace is written from one thread: spans nest as the calls do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch
from torch.profiler import record_function

PREFIX = "sponge."

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@dataclasses.dataclass(slots=True)
class Record:
    """One span or mark: ``end`` is None while a span is open and equals
    ``start`` for a mark; ``parent`` is the index in ``records`` of the
    span it opened inside (None at the top).  A span's record is also
    the context that opens and closes it (``ServeTrace.span``)."""
    name: str
    start: int
    end: Optional[int]
    parent: Optional[int]
    attrs: Dict[str, Any]
    trace: Optional["ServeTrace"] = dataclasses.field(
        default=None, repr=False, compare=False)
    rf: Any = dataclasses.field(default=None, repr=False, compare=False)

    def __enter__(self) -> "Record":
        tr = self.trace
        if _profiling():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.parent = tr._open[-1] if tr._open else None
        tr._open.append(len(tr.records))
        tr.records.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        self.trace._open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None


class ServeTrace:
    """In-memory spans and marks of one serving stack (module docstring).

    ``gang`` is the id of the latest gang (None before the first), which
    the step calls inside it carry."""

    def __init__(self):
        self.records: List[Record] = []
        self.gang: Optional[int] = None
        self._open: List[int] = []

    def span(self, name: str, **attrs) -> Record:
        """The record of the span ``sponge.<name>``, to enter as a context;
        its ``attrs`` may still grow."""
        return Record(PREFIX + name, 0, None, None, attrs, self)

    def mark(self, name: str, **attrs) -> None:
        """Record the instant ``sponge.<name>``."""
        t = time.perf_counter_ns()
        self.records.append(Record(PREFIX + name, t, t,
                                   self._open[-1] if self._open else None,
                                   attrs))

    def gang_span(self, **attrs) -> Record:
        """The span of a new gang, numbered in ``attrs["gang"]`` and in
        ``self.gang``."""
        self.gang = 0 if self.gang is None else self.gang + 1
        return self.span("gang", gang=self.gang, **attrs)

    def named(self, name: str) -> List[Record]:
        """The records of ``sponge.<name>``, in the order they opened."""
        full = PREFIX + name
        return [r for r in self.records if r.name == full]


def span(trace: Optional[ServeTrace], name: str, **attrs):
    """``trace.span(name, **attrs)``, or a context that records nothing
    (and enters as None) when ``trace`` is None."""
    return _OFF if trace is None else trace.span(name, **attrs)
