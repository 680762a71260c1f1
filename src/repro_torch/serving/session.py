"""The online session API: submit / update_slo / cancel, any engine.

Copy of ``repro.serving.session``: the ``SpongeSession`` protocol,
``SessionTranscript``, ``replay_transcript``, ``drive_session_events``,
``ExactSession`` over the object-based ``ScenarioRunner``, and the
struct-of-arrays sessions ``FastSession`` (over
``fastpath.FastSimRunner``), ``TokenFastSession`` (over the
continuous-batching ``fastpath.TokenFastSimRunner``) and
``FleetSession`` (over ``fleet.FleetFastSimRunner``: a tightened budget
re-routes through the fleet's arrival router).  A session is a live
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
``TokenSimBackend``, or the live ``TorchBackend`` on the card.  The
column sessions process the same events in the same order with the same
floats, over per-request columns instead of objects, so the fast
engines' ``run`` (``submit_batch`` + ``finish``) is decision for
decision the exact engine's.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import bisect_left, insort
from typing import (Any, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

from repro_torch.core.cost_model import Composition
from repro_torch.core.monitor import (array_window_rate,
                                      array_window_rate_cancel_aware,
                                      tick_window_rate)
from repro_torch.core.slo import Request
from repro_torch.serving.api import RunReport, build_array_report
from repro_torch.serving.fleet import normalize_fleet_events, route_request
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
        tr = r.trace
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
                if tr is not None:
                    tr.mark("admit", req=req.id)
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


# --------------------------------------------------------------------------
# struct-of-arrays sessions
# --------------------------------------------------------------------------
class _ColumnSession:
    """Shared plumbing of the struct-of-arrays sessions: per-request
    columns as growable Python lists (converted to numpy once at report
    time), a byte per request for the handle lifecycle, the pending
    arrival heap, and the cancel-aware λ window.  Handles are row
    indices in submission order — exactly the indices the fast EDF
    queues carry."""

    # per-request columns: scalar reads/writes work on both backings;
    # the list backing additionally supports append (incremental submit)
    _COLUMNS = ("_send", "_arrival", "_cl", "_slo", "_dl", "_size",
                "_ptok", "_dtok", "_tbt", "_finish")

    def __init__(self, runner):
        self.runner = runner
        self.now = 0.0
        self.events_processed = 0
        self._n = 0
        self._send: List[float] = []
        self._arrival: List[float] = []
        self._cl: List[float] = []
        self._slo: List[float] = []
        self._dl: List[float] = []
        self._size: List[float] = []
        self._ptok: List[int] = []
        self._dtok: List[int] = []
        self._tbt: List[float] = []
        self._finish: List[float] = []
        # the batch-replay fast path keeps the columns as numpy arrays
        # (no per-request boxing at the million-request scale); the
        # first *incremental* submit converts them to lists once
        self._cols_are_arrays = False
        self._state = bytearray()
        self._pending: List[tuple] = []      # (arrival, handle)
        self._max_arrival = 0.0
        self._n_cancelled = 0
        # λ window: processed arrivals + retracted (cancelled) arrivals
        self._arr: List[float] = []
        self._w0 = 0
        self._cxl: List[float] = []
        self._cw0 = 0
        # batch-replay tick-granular λ: when the workload is one adopted
        # arrival-sorted column and nothing gets cancelled, the λ window
        # reads the column directly at tick time (tick_window_rate) and
        # the event loop skips the per-arrival append entirely
        self._tick_lam = False
        self._next_tick = 0.0

    def _ensure_lists(self) -> None:
        """Flip array-backed columns to appendable lists (one-time cost,
        only paid when batch submits are mixed with incremental ones)."""
        self._tick_off()
        if self._cols_are_arrays:
            for name in self._COLUMNS:
                setattr(self, name, getattr(self, name).tolist())
            self._cols_are_arrays = False

    def _tick_off(self) -> None:
        """Leave tick-granular λ mode: materialize the processed-arrival
        list the incremental estimator expects.  In batch-replay mode
        arrivals pop strictly in column order, so the processed set is
        exactly the first ``n - len(pending)`` rows; the window pointer
        ``_w0`` transfers unchanged."""
        if self._tick_lam:
            self._tick_lam = False
            k = self._n - len(self._pending)
            self._arr = np.asarray(self._arrival[:k], np.float64).tolist()

    # -- submission --------------------------------------------------------
    def submit(self, req: Optional[Request] = None, *,
               send: Optional[float] = None, comm_latency: float = 0.0,
               slo: float = 1.0, size_kb: float = 200.0,
               deadline: Optional[float] = None, prompt_tokens: int = 1,
               decode_tokens: int = 0, tbt_slo: float = INF,
               payload: Any = None) -> int:
        """Submit one request; returns its handle (the row index)."""
        if req is not None:
            send, comm_latency = req.arrival - req.comm_latency, \
                req.comm_latency
            slo, size_kb, deadline = req.slo, req.size_kb, req.deadline
            prompt_tokens, decode_tokens = req.prompt_tokens, \
                req.decode_tokens
            tbt_slo = req.tbt_slo
        send = float(send or 0.0)
        arrival = send + comm_latency
        if arrival < self.now - 1e-12:
            raise ValueError(f"arrival {arrival} is in the session's past "
                             f"(now={self.now})")
        dl = (send + slo) if deadline is None else float(deadline)
        self._ensure_lists()
        h = self._n
        self._n += 1
        self._send.append(send)
        self._arrival.append(arrival)
        self._cl.append(float(comm_latency))
        self._slo.append(float(slo))
        self._dl.append(dl)
        self._size.append(float(size_kb))
        self._ptok.append(int(prompt_tokens))
        self._dtok.append(int(decode_tokens))
        self._tbt.append(float(tbt_slo))
        self._finish.append(float("nan"))
        self._state.append(PENDING)
        heapq.heappush(self._pending, (arrival, h))
        self._max_arrival = max(self._max_arrival, arrival)
        self._on_submit()
        return h

    def submit_batch(self, batch: RequestBatch) -> range:
        """Submit a whole arrival-sorted workload in one vectorized
        append; returns the handle range."""
        n = len(batch)
        if n and np.any(np.diff(batch.arrival) < 0):
            raise ValueError("RequestBatch must be sorted by arrival")
        if n and float(batch.arrival[0]) < self.now - 1e-12:
            raise ValueError("batch starts in the session's past")
        h0 = self._n
        if h0 == 0 and not self._pending:
            # the batch-replay fast path: adopt the workload's columns
            # as (decoupled) numpy arrays — no per-request boxing
            self._send = np.array(batch.send, np.float64)
            self._arrival = np.array(batch.arrival, np.float64)
            self._cl = np.array(batch.comm_latency, np.float64)
            self._slo = np.array(batch.slo, np.float64)
            self._dl = np.array(batch.deadline, np.float64)
            self._size = np.array(batch.size_kb, np.float64)
            self._ptok = np.array(batch.prompt_tokens, np.int64)
            self._dtok = np.array(batch.decode_tokens, np.int64)
            self._tbt = np.array(batch.tbt_slo, np.float64)
            self._finish = np.full(n, np.nan)
            self._cols_are_arrays = True
            self._tick_lam = self._TICK_LAM
        else:
            self._ensure_lists()
            self._send.extend(batch.send.tolist())
            self._arrival.extend(batch.arrival.tolist())
            self._cl.extend(batch.comm_latency.tolist())
            self._slo.extend(batch.slo.tolist())
            self._dl.extend(batch.deadline.tolist())
            self._size.extend(batch.size_kb.tolist())
            self._ptok.extend(batch.prompt_tokens.tolist())
            self._dtok.extend(batch.decode_tokens.tolist())
            self._tbt.extend(batch.tbt_slo.tolist())
            self._finish.extend([float("nan")] * n)
        self._state.extend(bytes(n))
        pairs = list(zip(batch.arrival.tolist(), range(h0, h0 + n)))
        if self._pending:
            self._pending.extend(pairs)
            heapq.heapify(self._pending)
        else:
            self._pending = pairs            # sorted list is a valid heap
        self._n = h0 + n
        if n:
            self._max_arrival = max(self._max_arrival,
                                    float(batch.arrival[-1]))
        self._on_submit()
        return range(h0, h0 + n)

    def _on_submit(self) -> None:
        """Hook for subclasses (token sessions rebind queue columns)."""

    # -- renegotiation -----------------------------------------------------
    def update_slo(self, handle: int, *, deadline: Optional[float] = None,
                   slo: Optional[float] = None,
                   net_latency: Optional[float] = None) -> bool:
        """Renegotiate a pending or queued request's deadline; False once
        it has dispatched, finished, or been cancelled (or the handle is
        unknown)."""
        if not 0 <= handle < self._n:
            return False
        st = self._state[handle]
        if st >= DONE:
            return False
        new_dl = _new_deadline(self._send[handle], self._slo[handle],
                               deadline, slo, net_latency)
        if slo is not None:
            self._slo[handle] = float(slo)
        if st == PENDING:
            self._dl[handle] = new_dl
            return True
        if not self._requeue_update(handle, new_dl):
            return False
        self._dl[handle] = new_dl
        self._post_mutate()
        return True

    def _requeue_update(self, handle: int, new_dl: float) -> bool:
        return self.runner.queue.update_deadline(handle, new_dl)

    def cancel(self, handle: int) -> bool:
        """Withdraw a pending or queued request; double-cancel safe,
        unknown handles refused."""
        if not 0 <= handle < self._n:
            return False
        self._tick_off()     # cancels break the derived-count invariant
        st = self._state[handle]
        if st == PENDING:
            self._state[handle] = CANCELLED
            self._n_cancelled += 1
            return True
        if st != QUEUED or not self._requeue_cancel(handle):
            return False
        self._state[handle] = CANCELLED
        self._n_cancelled += 1
        insort(self._cxl, self._arrival[handle])   # retract from λ
        self._post_mutate()
        return True

    def _requeue_cancel(self, handle: int) -> bool:
        return self.runner.queue.cancel(handle)

    def _post_mutate(self) -> None:
        """Re-trigger dispatch after a mid-flight mutation."""
        self._dispatch(self.now)

    def _dispatch(self, t: float) -> None:  # pragma: no cover
        raise NotImplementedError

    def record(self, handle: int) -> dict:
        """Per-request completion record."""
        st = self._state[handle]
        fin = self._finish[handle]
        status = {PENDING: "pending", QUEUED: "queued",
                  CANCELLED: "cancelled"}.get(st, None)
        if status is None:
            status = "done" if fin == fin else "running"
        return {"handle": handle, "arrival": self._arrival[handle],
                "deadline": self._dl[handle],
                "finish": fin if fin == fin else None, "status": status,
                "violated": (fin > self._dl[handle] + 1e-9)
                if fin == fin else None}

    # -- λ -----------------------------------------------------------------
    # subclasses whose event loop mutates λ state mid-flight (the token
    # session retracts overrun-cancelled streams in-loop) opt out
    _TICK_LAM = True

    def _rate(self, now: float) -> float:
        r = self.runner
        if self._tick_lam:
            lam, self._w0 = tick_window_rate(
                self._arrival, self._w0, now, r.rate_window, r.prior_rps)
            return lam
        if self._cxl:
            lam, self._w0, self._cw0 = array_window_rate_cancel_aware(
                self._arr, len(self._arr), self._w0, now, r.rate_window,
                r.prior_rps, self._cxl, self._cw0)
        else:
            lam, self._w0 = array_window_rate(
                self._arr, len(self._arr), self._w0, now, r.rate_window,
                r.prior_rps)
        return lam

    # -- reporting ---------------------------------------------------------
    def _columns_batch(self) -> RequestBatch:
        return RequestBatch(
            send=np.asarray(self._send, np.float64),
            arrival=np.asarray(self._arrival, np.float64),
            comm_latency=np.asarray(self._cl, np.float64),
            slo=np.asarray(self._slo, np.float64),
            deadline=np.asarray(self._dl, np.float64),
            size_kb=np.asarray(self._size, np.float64),
            prompt_tokens=np.asarray(self._ptok, np.int64),
            decode_tokens=np.asarray(self._dtok, np.int64),
            tbt_slo=np.asarray(self._tbt, np.float64))

    def _default_horizon(self) -> float:
        return self._max_arrival + 60.0 if self._n else 60.0

    def finish(self, horizon: Optional[float] = None) -> RunReport:
        """Drain to ``horizon`` (default: last arrival + 60 s) and
        aggregate the uniform report."""
        if horizon is None:
            horizon = self._default_horizon()
        self.step_until(horizon)
        self.runner.events_processed = self.events_processed
        return self._report(horizon)

    def _report(self, horizon: float) -> RunReport:  # pragma: no cover
        raise NotImplementedError


class FastSession(_ColumnSession):
    """Online session over the struct-of-arrays :class:`FastSimRunner`.

    Owns the event cursor (pending arrivals, tick train, dynamic
    completions/wake-ups) and the dispatch pass; queue, slots and
    decision application stay on the runner.  ``FastSimRunner.run`` is a
    thin replay wrapper over this class.
    """

    def __init__(self, runner):
        super().__init__(runner)
        self._events: List[tuple] = []
        self._seq = itertools.count()
        self._busy_wake: Dict[int, float] = {}
        self._slack_wake: Dict[int, float] = {}

    def drive(self, policy, now: float) -> None:
        """One adaptation step (the runner drive path, session λ)."""
        due = policy.due(now) if hasattr(policy, "due") else True
        if not due:
            return
        lam = self._rate(now)
        r = self.runner
        wait0 = max(r.slots[0].busy_until - now, 0.0)
        d = policy.decide(now, r.queue, lam, initial_wait=wait0)
        r._apply(d, now)

    def step_until(self, t: float) -> None:
        """Advance virtual time, processing every event with time ≤ t."""
        _check_step_target(t)
        r = self.runner
        pend = self._pending
        events = self._events
        queue = r.queue
        dl = self._dl
        # tick-granular λ mode derives the window count from the arrival
        # column itself — no per-arrival Python append
        arr = None if self._tick_lam else self._arr
        state = self._state
        tick = r.tick
        policy = r.policy
        has_on_tick = hasattr(policy, "on_tick")
        pop = heapq.heappop
        n_events = 0
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
            n_events += 1
            if kind == 0:
                _, h = pop(pend)
                if state[h] == CANCELLED:
                    n_events -= 1
                    continue
                state[h] = QUEUED
                queue.push(dl[h], h)
                if arr is not None:
                    arr.append(et)
            elif kind == 1:
                self._next_tick += tick
                self.now = et
                if has_on_tick:
                    policy.on_tick(et, self)
                else:
                    self.drive(policy, et)
                r.core_samples.append((et, r.allocated_cores))
            else:
                pop(events)
            self.now = et
            self._dispatch(et)
        self.events_processed += n_events
        self.now = max(self.now, t)

    # spongelint: inline-of repro_torch.serving.api.ScenarioRunner._dispatch pin=1ec388f9ac90
    def _dispatch(self, t: float) -> None:
        """Slack-aware EDF dispatch over every slot (the FastSimRunner
        rules, verbatim: fill toward b, release a partial batch only
        under deadline pressure, precise deduplicated wake-ups)."""
        r = self.runner
        queue = r.queue
        if not queue._heap:
            return
        live = queue._live
        b_now = r.b
        lat = r._lat
        bucket_arr = r._bucket_arr
        margin = r.dispatch_margin
        tick = r.tick
        events = self._events
        seq = self._seq
        busy_wake = self._busy_wake
        slack_wake = self._slack_wake
        finish = self._finish
        state = self._state
        push = heapq.heappush
        for s in r.slots:
            if s.ready_at > t or s.busy_until > t:
                wake_t = (s.ready_at if s.ready_at > s.busy_until
                          else s.busy_until)
                if busy_wake.get(s.id) != wake_t:
                    busy_wake[s.id] = wake_t
                    push(events, (wake_t, next(seq), s.id))
                continue
            while queue._heap and s.busy_until <= t:
                if len(live) < b_now:
                    head_dl = queue._heap[0][0]
                    l_full = lat[(s.c, r._bucket(b_now))]
                    t_force = head_dl - l_full - margin
                    if t < t_force:
                        tw = min(t_force, t + tick)
                        if slack_wake.get(s.id) != tw:
                            slack_wake[s.id] = tw
                            push(events, (tw, next(seq), s.id))
                        break
                idxs = queue.pop_batch(b_now)
                m = len(idxs)
                bucket = int(bucket_arr[m])
                fin = t + lat[(s.c, bucket)]
                s.busy_until = fin
                r.bucket_log.append((t, s.c, bucket, m))
                for i in idxs:
                    finish[i] = fin
                    state[i] = DONE
                push(events, (fin, next(seq), s.id))

    def _report(self, horizon: float) -> RunReport:
        r = self.runner
        return build_array_report(
            r.policy, "sim-fast", self._columns_batch(),
            np.asarray(self._finish, np.float64), horizon,
            r.slots + r.dead, r.core_samples, r.bucket_log,
            n_cancelled=self._n_cancelled)


class TokenFastSession(_ColumnSession):
    """Online session over the continuous-batching
    :class:`TokenFastSimRunner`.

    Opts out of tick-granular λ (``_TICK_LAM = False``): speculative
    admission cancels overrun streams *inside* the step loop, which
    retracts arrivals from the λ window mid-flight — the derived-count
    shortcut would miss those retractions.

    Renegotiation applies to the *TTFT* deadline while a request waits
    for admission; once its prompt joins a decode step the stream is
    committed (``update_slo`` / ``cancel`` return False — exactly the
    point past which a real engine has spent the prefill).  Admission,
    step composition and the per-token accounting follow the batch
    loop's rules verbatim.

    Decode-length uncertainty: when the runner carries a non-point
    ``core.uncertainty.UncertaintyConfig``, admission
    is *speculative* — every stream joins with a decode-token budget
    (``config.budget_tokens(slo)``: the per-SLO-class quantile estimate
    widened by the predictor's slack) and a stream that exhausts its
    budget before finishing is **cancelled at the step boundary**: its
    slot frees immediately, the cancel flows through the session's cancel
    machinery (λ retraction via the ``_cxl`` window + ``n_cancelled``) and the
    request is excluded from latency/violation aggregates (``finish``
    stays NaN).  Finished and overrun streams both feed the shared
    length predictor, closing the calibration → solver-slack loop.
    With no config (or a point mass) none of this code runs and the
    deterministic loop is bit-identical to before.
    """

    _TICK_LAM = False

    def __init__(self, runner):
        super().__init__(runner)
        self._first_tok: List[float] = []
        self._tbt_bad: List[bool] = []
        # the running decode streams + the step in flight
        self._run_idx: List[int] = []
        self._run_rem: List[int] = []
        self._run_tbt: List[float] = []
        self._step_end = INF
        self._step_start = 0.0
        self._step_admit: List[int] = []
        self._step_total_ptok = 0
        self._step_decoders = 0
        self._tokens_served = 0
        self._decode_tokens_served = 0
        self._tbt_viol_tokens = 0
        self._rebind = False
        # speculative admission (parallel to _run_idx when tracking):
        # per-stream token budgets + the length each was planned at
        unc = getattr(runner, "uncertainty", None)
        self._unc = unc
        self._track = unc is not None and not unc.is_point()
        self._spec = self._track and unc.speculative
        self._run_cap: List[int] = []
        self._run_pred: List[float] = []
        self._n_overrun = 0

    def _on_submit(self) -> None:
        n = self._n - len(self._first_tok)
        self._first_tok.extend([float("nan")] * n)
        self._tbt_bad.extend([False] * n)
        self._rebind = True

    def _bind(self) -> None:
        if self._rebind:
            self.runner.queue.bind(np.asarray(self._ptok, np.float64),
                                   np.asarray(self._tbt, np.float64))
            self._rebind = False

    def drive(self, policy, now: float, active_slots: int = 0,
              tbt_budget: float = INF, initial_wait: float = 0.0) -> None:
        """One adaptation step over the token-aware decide protocol."""
        due = policy.due(now) if hasattr(policy, "due") else True
        if not due:
            return
        self._bind()
        lam = self._rate(now)
        d = policy.decide(now, self.runner.queue, lam,
                          initial_wait=initial_wait,
                          active_slots=active_slots, tbt_budget=tbt_budget)
        self.runner._apply(d, now)

    def _post_mutate(self) -> None:
        """Admission happens at step boundaries only — nothing to do."""

    def _start_step(self, t0: float) -> float:
        """Admit waiting requests, compose the step, return its end
        (INF when there is no work to run).  Admission is EDF-ordered
        and chunk-bounded by the cost model's prefill-token allowance
        for the tightest running TBT — see ``TokenFastSimRunner``."""
        r = self.runner
        queue = r.queue
        cost = r.cost
        slot = r.slots[0]
        ptoks = self._ptok
        run_idx, run_tbt = self._run_idx, self._run_tbt
        free = r.b - len(run_idx)
        admit: List[int] = []
        total = 0
        if free > 0 and queue._heap:
            allowance = (cost.prefill_token_allowance(
                slot.c, len(run_idx), min(run_tbt))
                if run_tbt else INF)
            heap = queue._heap
            live = queue._live
            state = self._state
            while heap and len(admit) < free:
                dl0, i = heap[0]
                if live.get(i) != dl0:        # stale (renegotiated away)
                    heapq.heappop(heap)
                    continue
                if total + ptoks[i] > allowance:
                    break
                heapq.heappop(heap)
                del live[i]
                state[i] = DONE               # committed to the stream
                admit.append(i)
                total += ptoks[i]
            queue._fix_top()
        if not admit and not run_idx:
            return INF
        self._step_admit = admit
        self._step_total_ptok = total
        self._step_decoders = len(run_idx)
        l = cost.step_latency(slot.c, Composition(total,
                                                  self._step_decoders))
        l += r._pending_penalty
        r._pending_penalty = 0.0
        self._step_start = t0
        return t0 + l

    def step_until(self, t: float) -> None:
        """Advance virtual time, processing every event with time ≤ t."""
        _check_step_target(t)
        r = self.runner
        pend = self._pending
        queue = r.queue
        dl = self._dl
        dtoks = self._dtok
        tbts = self._tbt
        arr = self._arr
        state = self._state
        slot = r.slots[0]
        tick = r.tick
        policy = r.policy
        first_tok = self._first_tok
        finish = self._finish
        tbt_bad = self._tbt_bad
        pop = heapq.heappop
        n_events = 0
        while True:
            ta = pend[0][0] if pend else INF
            tt = self._next_tick
            se = self._step_end
            if ta <= tt and ta <= se:
                et, kind = ta, 0
            elif tt <= se:
                et, kind = tt, 1
            else:
                et, kind = se, 2
            if et == INF or et > t:
                break
            n_events += 1
            self.now = et
            if kind == 0:                        # arrival
                _, h = pop(pend)
                if state[h] == CANCELLED:
                    n_events -= 1
                    continue
                state[h] = QUEUED
                queue.push(dl[h], h)
                arr.append(et)
            elif kind == 1:                      # adaptation tick
                self._next_tick += tick
                run_tbt_min = (min(self._run_tbt) if self._run_tbt
                               else INF)
                iw = (max(self._step_end - et, 0.0)
                      if self._step_end < INF else 0.0)
                self.drive(policy, et, active_slots=len(self._run_idx),
                           tbt_budget=run_tbt_min, initial_wait=iw)
                r.core_samples.append((et, slot.c))
            else:                                # step boundary
                gap = et - self._step_start
                run_idx, run_rem, run_tbt = (self._run_idx, self._run_rem,
                                             self._run_tbt)
                run_cap, run_pred = self._run_cap, self._run_pred
                track, spec, unc = self._track, self._spec, self._unc
                nxt_idx: List[int] = []
                nxt_rem: List[int] = []
                nxt_tbt: List[float] = []
                nxt_cap: List[int] = []
                nxt_pred: List[float] = []
                for k in range(self._step_decoders):
                    i = run_idx[k]
                    self._tokens_served += 1
                    self._decode_tokens_served += 1
                    if gap > run_tbt[k] + 1e-12:
                        self._tbt_viol_tokens += 1
                        tbt_bad[i] = True
                    if run_rem[k] > 1:
                        if spec and run_cap[k] <= 1:
                            # cancel-on-overrun: the stream consumed its
                            # token budget without finishing — free the
                            # slot through the session's cancel machinery
                            # (λ retraction + n_cancelled); finish stays
                            # NaN so aggregates exclude the request
                            state[i] = CANCELLED
                            self._n_cancelled += 1
                            self._n_overrun += 1
                            insort(self._cxl, float(self._arrival[i]))
                            unc.observe(run_pred[k], float(dtoks[i]),
                                        float(self._slo[i]))
                        else:
                            nxt_idx.append(i)
                            nxt_rem.append(run_rem[k] - 1)
                            nxt_tbt.append(run_tbt[k])
                            if track:
                                nxt_cap.append(run_cap[k] - 1)
                                nxt_pred.append(run_pred[k])
                    else:
                        finish[i] = et
                        if track:
                            unc.observe(run_pred[k], float(dtoks[i]),
                                        float(self._slo[i]))
                for i in self._step_admit:
                    first_tok[i] = et
                    self._tokens_served += 1
                    if dtoks[i] > 0:
                        nxt_idx.append(i)
                        nxt_rem.append(int(dtoks[i]))
                        nxt_tbt.append(float(tbts[i]))
                        if track:
                            s = float(self._slo[i])
                            nxt_pred.append(unc.planned_length(s))
                            nxt_cap.append(unc.budget_tokens(s)
                                           if spec else (1 << 60))
                    else:
                        finish[i] = et
                self._run_idx, self._run_rem, self._run_tbt = (
                    nxt_idx, nxt_rem, nxt_tbt)
                self._run_cap, self._run_pred = nxt_cap, nxt_pred
                self._step_admit = []
                self._step_decoders = 0
                self._step_end = self._start_step(et)
            if self._step_end == INF and (queue._heap or self._run_idx):
                self._step_end = self._start_step(et)
        self.events_processed += n_events
        self.now = max(self.now, t)

    def _report(self, horizon: float) -> RunReport:
        r = self.runner
        r.overrun_cancels = self._n_overrun   # telemetry for run stats
        return r._token_report(
            self._columns_batch(),
            np.asarray(self._first_tok, np.float64),
            np.asarray(self._finish, np.float64),
            np.asarray(self._tbt_bad, bool),
            self._tokens_served, self._decode_tokens_served,
            self._tbt_viol_tokens, horizon,
            n_cancelled=self._n_cancelled)


class FleetSession(_ColumnSession):
    """Online session over the struct-of-arrays
    :class:`~repro_torch.serving.fleet.FleetFastSimRunner`.

    Mid-flight semantics on a fleet add one twist: **a tightened budget
    re-routes**.  The replica a request was originally routed to was
    chosen under the old deadline; when the budget tightens the request
    is pulled and re-offered to the configured router under its new
    deadline (cold-start aware, same tie-breaks as arrivals), while a
    relaxed budget re-keys in place.  Fleet disruptions
    (kill / restart events) flow through the same event cursor in the
    canonical tie order (arrivals, ticks, fleet events, completions).
    """

    def __init__(self, runner, fleet_events=()):
        super().__init__(runner)
        self._events: List[tuple] = []
        self._seq = itertools.count()
        self._busy_wake: Dict[int, float] = {}
        self._slack_wake: Dict[int, float] = {}
        self._fev = normalize_fleet_events(fleet_events)
        self._fi = 0

    # -- fleet-specific renegotiation --------------------------------------
    def _holding_replica(self, handle: int):
        for rep in self.runner.replicas:
            if handle in rep.queue._live:
                return rep
        return None

    def _requeue_update(self, handle: int, new_dl: float) -> bool:
        r = self.runner
        rep = self._holding_replica(handle)
        if rep is None:
            return False
        old = rep.queue._live[handle]
        track = r._track_dls
        if new_dl < old:
            # tightened: pull and re-offer through the arrival router
            rep.queue.cancel(handle)
            if track:
                del rep.dls[bisect_left(rep.dls, old)]
            j = route_request(r.router, r.replicas, new_dl, self.now,
                              cold_load=r._cold_load(self.now))
            tgt = r.replicas[j]
            tgt.queue.push(new_dl, handle)
            if track:
                insort(tgt.dls, new_dl)
        else:
            rep.queue.update_deadline(handle, new_dl)
            if track:
                del rep.dls[bisect_left(rep.dls, old)]
                insort(rep.dls, new_dl)
        return True

    def _requeue_cancel(self, handle: int) -> bool:
        rep = self._holding_replica(handle)
        if rep is None:
            return False
        old = rep.queue._live[handle]
        rep.queue.cancel(handle)
        if self.runner._track_dls:
            del rep.dls[bisect_left(rep.dls, old)]
        return True

    def _drive(self, t: float) -> None:
        """One adaptation step through the runner's single drive rule,
        with the session's cancel-aware λ."""
        r = self.runner
        pol = r.policy
        if hasattr(pol, "due") and not pol.due(t):
            return
        r._drive(t, lam=self._rate(t))

    def step_until(self, t: float) -> None:
        """Advance virtual time, processing every event with time ≤ t
        (arrivals, ticks, fleet events, completions — canonical order)."""
        _check_step_target(t)
        r = self.runner
        pend = self._pending
        events = self._events
        dl = self._dl
        arr = None if self._tick_lam else self._arr
        state = self._state
        fev = self._fev
        tick = r.tick
        track_dls = r._track_dls
        pop = heapq.heappop
        n_events = 0
        while True:
            ta = pend[0][0] if pend else INF
            tt = self._next_tick
            tf = fev[self._fi][0] if self._fi < len(fev) else INF
            td = events[0][0] if events else INF
            if ta <= tt and ta <= tf and ta <= td:
                et, kind = ta, 0
            elif tt <= tf and tt <= td:
                et, kind = tt, 1
            elif tf <= td:
                et, kind = tf, 2
            else:
                et, kind = td, 3
            if et == INF or et > t:
                break
            n_events += 1
            self.now = et
            if kind == 0:                        # arrival: route + enqueue
                _, h = pop(pend)
                if state[h] == CANCELLED:
                    n_events -= 1
                    continue
                state[h] = QUEUED
                j = route_request(r.router, r.replicas, dl[h], et,
                                  cold_load=r._cold_load(et))
                tgt = r.replicas[j]
                tgt.queue.push(dl[h], h)
                if track_dls:
                    insort(tgt.dls, dl[h])
                if arr is not None:
                    arr.append(et)
            elif kind == 1:                      # adaptation tick
                self._next_tick += tick
                self._drive(et)
                r.core_samples.append((et, r.allocated_cores))
            elif kind == 2:                      # fleet event
                _, ev_kind, ev_args = fev[self._fi]
                self._fi += 1
                r._fleet_event(ev_kind, ev_args, et)
            else:                                # completion / wake-up
                pop(events)
            self._dispatch(et)
        self.events_processed += n_events
        self.now = max(self.now, t)

    # spongelint: inline-of repro_torch.serving.session.FastSession._dispatch pin=4a61b16de14b
    def _dispatch(self, t: float) -> None:
        """Per-replica slack-aware EDF dispatch (FleetFastSimRunner
        rules, verbatim)."""
        r = self.runner
        b_now = r.b
        lat = r._lat
        bucket_arr = r._bucket_arr
        margin = r.dispatch_margin
        tick = r.tick
        track_dls = r._track_dls
        events = self._events
        seq = self._seq
        busy_wake = self._busy_wake
        slack_wake = self._slack_wake
        finish = self._finish
        state = self._state
        push = heapq.heappush
        for rep in r.replicas:
            q = rep.queue._heap
            if not q:
                continue
            if rep.ready_at > t or rep.busy_until > t:
                wake_t = (rep.ready_at if rep.ready_at > rep.busy_until
                          else rep.busy_until)
                if busy_wake.get(rep.id) != wake_t:
                    busy_wake[rep.id] = wake_t
                    push(events, (wake_t, next(seq), rep.id))
                continue
            live = rep.queue._live
            while q and rep.busy_until <= t:
                if len(live) < b_now:
                    head_dl = q[0][0]
                    l_full = lat[(rep.c, r._bucket(b_now))]
                    t_force = head_dl - l_full - margin
                    if t < t_force:
                        tw = min(t_force, t + tick)
                        if slack_wake.get(rep.id) != tw:
                            slack_wake[rep.id] = tw
                            push(events, (tw, next(seq), rep.id))
                        break
                idxs = rep.queue.pop_batch(b_now)
                m = len(idxs)
                if track_dls:
                    del rep.dls[:m]   # pop_batch took the m earliest
                bucket = int(bucket_arr[m])
                fin = t + lat[(rep.c, bucket)]
                rep.busy_until = fin
                r.bucket_log.append((t, rep.c, bucket, m))
                for i in idxs:
                    finish[i] = fin
                    state[i] = DONE
                push(events, (fin, next(seq), rep.id))

    def _report(self, horizon: float) -> RunReport:
        r = self.runner
        batch = self._columns_batch()
        finish = np.asarray(self._finish, np.float64)
        rep = build_array_report(
            r.policy, r.backend_name, batch, finish, horizon,
            r.replicas + r.dead, r.core_samples, r.bucket_log,
            n_cancelled=self._n_cancelled)
        return r._enrich_report(rep, finish, batch.deadline, horizon)
