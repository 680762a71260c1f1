"""The online session API over the object-based ``ScenarioRunner``:
submit / update_slo / cancel.

Copy of ``repro.serving.session`` cut to the exact engine: the
``SpongeSession`` protocol, ``SessionTranscript``, ``replay_transcript``,
``drive_session_events`` and ``ExactSession``.  A session is a live
handle on a serving engine through which a client (or a
network-telemetry feed) can

* ``submit(...)`` a request and receive a **handle**,
* ``update_slo(handle, ...)`` -- renegotiate a *queued* request's
  deadline mid-flight (a network fade tightens the budget, a recovery
  relaxes it),
* ``cancel(handle)`` -- withdraw a queued or not-yet-arrived request,
* ``step_until(t)`` -- advance the engine's virtual clock,
* ``finish(horizon)`` -- drain and collect the uniform ``RunReport``.

``ExactSession`` keeps arrivals on a pending heap keyed ``(arrival,
submission order)``, an incremental tick train and a heap of dynamic
events, merged in the reference's order (arrivals, then ticks, then
dynamic events at equal times); ``update_slo`` / ``cancel`` apply
between events at the session's clock and re-trigger a dispatch pass.
Cancelled requests retract their arrival from the λ window and are
excluded from every served/violation aggregate (``RunReport.
n_cancelled``).  ``ScenarioRunner.run`` is the no-renegotiation replay
over it, and it runs on any backend: ``SimBackend``,
``TokenSimBackend``, or the live ``TorchBackend`` on the card.
"""
from __future__ import annotations

import heapq
import itertools
from typing import (Any, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

from repro_torch.core.slo import Request
from repro_torch.serving.api import RunReport
from repro_torch.serving.workload import RequestBatch

INF = float("inf")

# handle lifecycle states
PENDING, QUEUED, DONE, CANCELLED = 0, 1, 2, 3


@runtime_checkable
class SpongeSession(Protocol):
    """The online serving session protocol (see the module docstring)."""

    now: float

    def submit(self, req: Optional[Request] = None, **fields) -> int: ...

    def submit_batch(self, batch: RequestBatch) -> Sequence[int]: ...

    def update_slo(self, handle: int, *, deadline: Optional[float] = None,
                   slo: Optional[float] = None,
                   net_latency: Optional[float] = None) -> bool: ...

    def cancel(self, handle: int) -> bool: ...

    def step_until(self, t: float) -> None: ...

    def finish(self, horizon: Optional[float] = None) -> RunReport: ...

    def record(self, handle: int) -> dict: ...


def _check_step_target(t: float) -> None:
    """``step_until`` needs a finite target: the adaptation-tick train
    is unbounded, so an infinite target would loop forever."""
    if not t < INF or t != t:
        raise ValueError(f"step_until needs a finite time (got {t}); "
                         "use finish(horizon) to drain a run")


def _new_deadline(send: float, cur_slo: float, deadline, slo,
                  net_latency) -> float:
    """Resolve a renegotiated absolute deadline.

    Priority: an explicit ``deadline`` wins; otherwise the deadline is
    rebuilt from the (possibly updated) end-to-end ``slo`` minus the
    anticipated response-path ``net_latency`` — the paper's dynamic-SLO
    quantity: when the client's link fades after submission, the
    response will take longer, so the server must finish earlier.
    """
    if deadline is not None:
        return float(deadline)
    s = cur_slo if slo is None else float(slo)
    return send + s - (0.0 if net_latency is None else float(net_latency))


class SessionTranscript:
    """A recorded stream of session ops, replayable on any engine.

    Ops reference workload *rows* (indices into the ``RequestBatch`` the
    transcript was recorded against), never engine handles — replay maps
    rows to whatever handles the target session allocates:

    * ``("submit", t, row)``            — submit row at its arrival t;
    * ``("update", t, row, deadline)``  — renegotiate to ``deadline``;
    * ``("cancel", t, row)``            — cancel.
    """

    def __init__(self, ops: Optional[List[tuple]] = None):
        self.ops: List[tuple] = list(ops or [])

    @classmethod
    def from_batch(cls, batch: RequestBatch,
                   events: Sequence[tuple] = ()) -> "SessionTranscript":
        """Record a transcript: one submit per row at its arrival time,
        merged time-stably with a renegotiation event stream (items
        shaped like the ``session_events`` scenario meta:
        ``(t, "update", row, new_deadline)`` / ``(t, "cancel", row)``)."""
        ops = [("submit", float(t), i)
               for i, t in enumerate(batch.arrival)]
        for ev in events:
            if ev[1] == "update":
                ops.append(("update", float(ev[0]), int(ev[2]),
                            float(ev[3])))
            else:
                ops.append(("cancel", float(ev[0]), int(ev[2])))
        ops.sort(key=lambda op: op[1])       # stable: submits precede
        return cls(ops)


def _row_request(batch: RequestBatch, i: int) -> Request:
    """Materialize one workload row as a ``Request``."""
    return Request(deadline=float(batch.deadline[i]),
                   arrival=float(batch.arrival[i]),
                   comm_latency=float(batch.comm_latency[i]),
                   slo=float(batch.slo[i]),
                   size_kb=float(batch.size_kb[i]),
                   prompt_tokens=int(batch.prompt_tokens[i]),
                   decode_tokens=int(batch.decode_tokens[i]),
                   tbt_slo=float(batch.tbt_slo[i]))


def replay_transcript(session: SpongeSession, transcript: SessionTranscript,
                      batch: RequestBatch,
                      horizon: Optional[float] = None) -> RunReport:
    """Drive ``session`` op by op — the true online path: each submit is
    pushed just before the clock reaches its arrival (so arrival events
    keep their tie precedence over same-time ticks), each renegotiation
    applies after the engine has advanced to its timestamp."""
    handles: Dict[int, int] = {}
    for op in transcript.ops:
        kind, t = op[0], op[1]
        if kind == "submit":
            handles[op[2]] = session.submit(_row_request(batch, op[2]))
            session.step_until(t)
        elif kind == "update":
            session.step_until(t)
            session.update_slo(handles[op[2]], deadline=op[3])
        else:
            session.step_until(t)
            session.cancel(handles[op[2]])
    return session.finish(horizon)


def drive_session_events(session: SpongeSession, handles: Sequence[int],
                         events: Sequence[tuple]) -> Dict[str, int]:
    """Apply a scenario's mid-flight event stream (``session_events``
    meta: time-sorted ``(t, "update", row, new_deadline)`` /
    ``(t, "cancel", row)`` tuples) to an already-submitted session.
    Returns applied/no-op counts (an event whose request already
    dispatched is a no-op, exactly like a real telemetry feed racing
    the scheduler)."""
    applied = {"update": 0, "cancel": 0, "noop": 0}
    for ev in events:
        t, kind, i = float(ev[0]), ev[1], int(ev[2])
        session.step_until(t)
        if kind == "update":
            ok = session.update_slo(handles[i], deadline=float(ev[3]))
        else:
            ok = session.cancel(handles[i])
        applied[kind if ok else "noop"] += 1
    return applied


class ExactSession:
    """Online session over the object-based ``ScenarioRunner``.

    Wraps a runner (policy + backend already composed); arrivals live on
    a pending heap keyed ``(arrival, submission order)`` and are fed to
    the runner's streamed loop with the same tie precedence the batch
    path used (arrivals, then ticks, then dynamic events).  Dispatch,
    pool mutation and reporting stay on the runner — the session only
    owns the event cursor and the renegotiation surface.
    """

    def __init__(self, runner):
        self.runner = runner
        self.now = 0.0
        self.events_processed = 0
        self._pending: List[tuple] = []      # (arrival, seq, req, payload)
        self._pseq = itertools.count()
        self._events: List[tuple] = []       # dynamic: completions/wake-ups
        self._seq = itertools.count()
        self._next_tick = 0.0
        self._max_arrival = 0.0
        self._reqs: Dict[int, Request] = {}
        self._status: Dict[int, int] = {}    # PENDING / CANCELLED marks
        runner._wake = {}
        runner._slack_wake = {}
        runner.events_processed = 0

    # -- the client surface ------------------------------------------------
    def submit(self, req: Optional[Request] = None, *, payload: Any = None,
               send: Optional[float] = None, comm_latency: float = 0.0,
               slo: float = 1.0, size_kb: float = 200.0,
               deadline: Optional[float] = None, prompt_tokens: int = 1,
               decode_tokens: int = 0,
               tbt_slo: float = INF) -> int:
        """Submit one request (a ``Request`` or its fields); returns the
        handle every later ``update_slo`` / ``cancel`` uses."""
        if req is None:
            arrival = (send or 0.0) + comm_latency
            req = Request.make(arrival=arrival, comm_latency=comm_latency,
                               slo=slo, size_kb=size_kb,
                               prompt_tokens=prompt_tokens,
                               decode_tokens=decode_tokens, tbt_slo=tbt_slo)
            if deadline is not None:
                req.deadline = float(deadline)
        if req.arrival < self.now - 1e-12:
            raise ValueError(f"arrival {req.arrival} is in the session's "
                             f"past (now={self.now})")
        heapq.heappush(self._pending,
                       (req.arrival, next(self._pseq), req, payload))
        self._reqs[req.id] = req
        self._status[req.id] = PENDING
        self._max_arrival = max(self._max_arrival, req.arrival)
        return req.id

    def submit_batch(self, batch: RequestBatch) -> List[int]:
        """Submit a whole workload (arrival order); returns its handles."""
        return [self.submit(r) for r in batch.to_requests()]

    def update_slo(self, handle: int, *, deadline: Optional[float] = None,
                   slo: Optional[float] = None,
                   net_latency: Optional[float] = None) -> bool:
        """Renegotiate a pending or queued request's deadline; False once
        it has dispatched, finished, or been cancelled."""
        req = self._reqs.get(handle)
        if req is None:
            return False
        new_dl = _new_deadline(req.arrival - req.comm_latency, req.slo,
                               deadline, slo, net_latency)
        if slo is not None:
            req.slo = float(slo)
        st = self._status.get(handle, DONE)
        if st == PENDING:
            req.deadline = new_dl
            return True
        if st == CANCELLED:
            return False
        r = self.runner
        if not r.queue.update_deadline(handle, new_dl):
            return False
        # a tightened head must not wait for the next tick
        r._dispatch(self.now, self._events, self._seq)
        return True

    def cancel(self, handle: int) -> bool:
        """Withdraw a pending or queued request; double-cancel safe."""
        st = self._status.get(handle, DONE)
        if st == PENDING:
            self._status[handle] = CANCELLED
            # never arrived: counts as cancelled but there is no λ
            # observation to retract (same rule as the column sessions)
            self.runner.monitor.cancelled.append(self._reqs[handle])
            return True
        if st != QUEUED:
            return False
        req = self.runner.queue.cancel(handle)
        if req is None:
            return False
        self._status[handle] = CANCELLED
        self.runner.monitor.observe_cancel(req)
        # same mutation contract as the column sessions: re-trigger a
        # dispatch pass so the wake-event streams cannot drift
        self.runner._dispatch(self.now, self._events, self._seq)
        return True

    def record(self, handle: int) -> dict:
        """Per-request completion record."""
        req = self._reqs[handle]
        st = self._status.get(handle, DONE)
        status = {PENDING: "pending", QUEUED: "queued",
                  CANCELLED: "cancelled"}.get(st, "done")
        if st == QUEUED and handle not in self.runner.queue:
            status = "done" if req.finish is not None else "running"
        return {"handle": handle, "arrival": req.arrival,
                "deadline": req.deadline, "finish": req.finish,
                "first_token": req.first_token, "status": status,
                "violated": req.violated if req.finish is not None
                else None}

    # -- the clock ---------------------------------------------------------
    def step_until(self, t: float) -> None:
        """Advance virtual time, processing every event with time ≤ t."""
        _check_step_target(t)
        r = self.runner
        pend = self._pending
        events = self._events
        while True:
            ta = pend[0][0] if pend else INF
            tt = self._next_tick
            td = events[0][0] if events else INF
            if ta <= tt and ta <= td:
                et, kind = ta, 0
            elif tt <= td:
                et, kind = tt, 1
            else:
                et, kind = td, 2
            if et == INF or et > t:
                break
            self.events_processed += 1
            self.now = et
            r.now = et
            if kind == 0:
                _, _, req, payload = heapq.heappop(pend)
                if self._status.get(req.id) == CANCELLED:
                    self.events_processed -= 1
                    continue
                self._status[req.id] = QUEUED
                r.submit(req, payload)
            elif kind == 1:
                self._next_tick += r.tick
                if hasattr(r.policy, "on_tick"):
                    r.policy.on_tick(et, r)
                else:
                    r.drive(r.policy, et)
                r.core_samples.append((et, r.allocated_cores))
            else:
                heapq.heappop(events)
            r._dispatch(et, events, self._seq)
        self.now = max(self.now, t)

    def finish(self, horizon: Optional[float] = None) -> RunReport:
        """Drain to ``horizon`` (default: last arrival + 60 s) and
        aggregate the uniform report."""
        if horizon is None:
            horizon = self._max_arrival + 60.0 if self._reqs else 60.0
        self.step_until(horizon)
        self.runner.events_processed = self.events_processed
        return self.runner.results(horizon)
