"""The Sponge serving API: one control plane, pluggable policies and
backends.

Copy of ``repro.serving.api`` cut to what the fixed-work and token
paths use:

* ``SchedulingPolicy`` -- anything with ``decide(now, queue, lam,
  initial_wait) -> Decision`` (optionally ``due(now)``): the Sponge
  scaler and the baselines of ``core.baselines``;
* ``ExecutionBackend`` -- a pool of vertically scalable slots
  (``Server``, ``_PooledBackend``) plus ``execute(batch, c, b, now) ->
  finish_time``.  ``SimBackend`` finishes batches on the calibrated
  ``PerfModel`` clock and ``TokenSimBackend`` gangs on the
  ``TokenCostModel`` clock; ``TorchBackend`` runs the ``(c, b)`` executable
  table on the device and advances time by the measured wall latency
  (``clock="measured"``) or by the model's prediction
  (``clock="modeled"``, event for event the ``SimBackend`` run);
* ``ScenarioRunner`` -- the object-based event loop, returning a
  ``RunReport``; ``build_array_report`` is the same report over the
  struct-of-arrays engines' columns (``serving.fastpath``);
* ``SpongeServer`` -- the facade; ``make_sim_server`` /
  ``make_live_server`` build one by name.

The live table (``build_llm_step_fns``) serves the model on the Hopper
kernels: one entry is a prefill plus ``gen_tokens`` greedy decode steps,
captured on the card as one CUDA graph at warm-up.  On one device every
``c`` entry shares the same function, so a resize changes scheduling
only.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.baselines import FA2Policy, SpongePolicy, StaticPolicy
from repro_torch.core.monitor import Monitor
from repro_torch.core.perf_model import PerfModel, yolov5s_like
from repro_torch.core.predictive import (PredictivePolicy,
                                         PredictiveSpongeScaler)
from repro_torch.core.queueing import EDFQueue
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.slo import Decision, Request
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.core.vertical import TimedExecutor, VerticalScaledInstance
from repro_torch.models import build_model
from repro_torch.models.api import resolve_device
from repro_torch.serving.capture import CapturedStep
from repro_torch.serving.trace import span
from repro_torch.serving.workload import WorkloadGenerator

_sid = itertools.count()


# --------------------------------------------------------------------------
# protocols
# --------------------------------------------------------------------------
@runtime_checkable
class SchedulingPolicy(Protocol):
    """One decision interface for every scaling policy."""
    name: str

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision: ...


@runtime_checkable
class ExecutionBackend(Protocol):
    """A pool of vertically scalable slots + a way to execute batches."""
    c_set: Tuple[int, ...]
    b_set: Tuple[int, ...]

    def apply(self, d: Decision, now: float) -> None: ...

    def execute(self, batch: List[Request], c: int, b: int,
                now: float) -> float: ...

    def core_seconds(self, horizon: float) -> float: ...



def round_up_c(c_set: Sequence[int], c: int) -> int:
    """Smallest available core count >= c (never round a feasible Decision
    down), falling back to max(c_set) when c exceeds every entry."""
    up = [cc for cc in c_set if cc >= c]
    return min(up) if up else max(c_set)


def resolve_decision(c_set: Sequence[int], d: Decision) -> Tuple[int, int]:
    """The decision-application rule: ``c`` rounds *up* to the nearest
    available entry (a feasible Decision must never be weakened), ``b``
    is floored at 1."""
    return round_up_c(c_set, d.c), max(1, int(d.b))


@dataclass
class Server:
    """One servable slot: a vertically scaled instance + availability."""
    instance: VerticalScaledInstance
    ready_at: float = 0.0
    busy_until: float = 0.0
    alive_since: float = 0.0
    dead_at: Optional[float] = None
    id: int = field(default_factory=lambda: next(_sid))

    def core_seconds(self, horizon: float) -> float:
        end = min(self.dead_at if self.dead_at is not None else horizon,
                  horizon)
        self.instance.account(max(end, self.alive_since))
        return self.instance.core_seconds


class _PooledBackend:
    """Slot-pool mechanics of the execution backends: in-place
    vertical resize, horizontal scale to Decision.n (scale-ups may pay
    ``Decision.scale_up_delay`` before serving), core-second accounting."""

    name = "base"

    def __init__(self, perf: PerfModel, c_set: Sequence[int],
                 b_set: Sequence[int], c0: int = 1,
                 resize_penalty: float = 0.005):
        self.perf = perf
        self.c_set = tuple(sorted(c_set))
        self.b_set = tuple(sorted(b_set))
        self.resize_penalty = resize_penalty
        self.pool: List[Server] = []
        self.dead: List[Server] = []
        self.monitor: Optional[Monitor] = None   # bound by ScenarioRunner
        self.add_slot(c0, ready_at=0.0, now=0.0)

    # -- pool management ---------------------------------------------------
    def add_slot(self, c: int, ready_at: float = 0.0,
                 now: float = 0.0) -> Server:
        inst = VerticalScaledInstance(self.c_set, self.b_set, self.perf,
                                      c0=c, resize_penalty=self.resize_penalty)
        inst.account(now)
        srv = Server(instance=inst, ready_at=ready_at, alive_since=now)
        self.pool.append(srv)
        return srv

    def remove_slots(self, n: int, now: float) -> None:
        # remove youngest servers first, never the last one
        for _ in range(min(n, len(self.pool) - 1)):
            srv = self.pool.pop()
            srv.dead_at = max(now, srv.busy_until)
            self.dead.append(srv)

    @property
    def allocated_cores(self) -> int:
        return sum(s.instance.c for s in self.pool)

    def core_seconds(self, horizon: float) -> float:
        return (sum(s.core_seconds(horizon) for s in self.pool)
                + sum(s.core_seconds(horizon) for s in self.dead))

    # -- decision application (vertical + horizontal) ----------------------
    def apply(self, d: Decision, now: float) -> None:
        c, _ = resolve_decision(self.c_set, d)
        for srv in self.pool:
            penalty = srv.instance.resize(c, now)
            if penalty:
                srv.busy_until = max(srv.busy_until, now) + penalty
        n = max(1, getattr(d, "n", 1))
        cur = len(self.pool)
        if n > cur:
            for _ in range(n - cur):
                self.add_slot(c, ready_at=now + d.scale_up_delay, now=now)
        elif n < cur:
            self.remove_slots(cur - n, now)

    # -- hooks -------------------------------------------------------------
    def on_submit(self, req: Request, payload: Any) -> None:
        pass


class SimBackend(_PooledBackend):
    """Discrete-event execution: batch finish times come from the
    calibrated PerfModel -- nothing actually runs (the Fig. 4 path)."""

    name = "sim"

    def execute(self, batch: List[Request], c: int, b: int,
                now: float) -> float:
        return now + float(self.perf.latency(b, c))


class TokenSimBackend(_PooledBackend):
    """Discrete-event *continuous-batching* execution over a token-level
    cost model (``core.cost_model.TokenCostModel``).

    A dispatched gang is served phase-aware: one prefill burst covering
    every prompt (each request's **first token** -- its TTFT -- lands
    when the burst finishes), then decode steps in which every live
    stream gains one token and requests **leave the running batch as
    their streams finish** (step latency tracks the shrinking slot
    count, per the token cost model).  Per-request ``first_token`` /
    ``finish`` / ``tbt_violations`` are written here -- the runner keeps
    whatever the backend recorded -- and the slot frees when the last
    stream drains.  The cost model also quacks like a PerfModel
    (full-service ``latency(b, c)``), which the runner's slack-aware
    dispatch and the pooled-slot bookkeeping consume.

    Decode-length uncertainty: a non-point
    ``core.uncertainty.UncertaintyConfig`` arms speculative execution --
    every decode stream carries a token budget
    (``config.budget_tokens(slo)``) and a stream that exhausts it before
    finishing is cancelled mid-gang: its request is flagged
    ``cancelled`` (the runner routes it through
    ``Monitor.observe_cancel``, retracting its λ contribution and
    excluding it from every aggregate) and it stops consuming decode
    steps.  Finished and overrun streams feed the shared length
    predictor.  With no config (or a point mass) the loop runs the
    deterministic path verbatim.
    """

    name = "token-sim"

    def __init__(self, cost, c_set: Sequence[int], b_set: Sequence[int],
                 c0: int = 1, resize_penalty: float = 0.005,
                 uncertainty=None):
        super().__init__(cost, c_set, b_set, c0=c0,
                         resize_penalty=resize_penalty)
        self.cost = cost
        self.tokens_served = 0
        self.uncertainty = uncertainty
        self.overrun_cancels = 0

    def execute(self, batch: List[Request], c: int, b: int,
                now: float) -> float:
        unc = self.uncertainty
        track = unc is not None and not unc.is_point()
        spec = track and unc.speculative
        total_prompt = sum(r.prompt_tokens for r in batch)
        t = now + float(self.cost.prefill_latency(c, total_prompt))
        live: List[tuple[Request, int, int]] = []
        for r in batch:
            r.first_token = t
            self.tokens_served += 1          # the prefill's first token
            if r.decode_tokens > 0:
                cap = (unc.budget_tokens(r.slo) if spec else (1 << 60))
                live.append((r, r.decode_tokens, cap))
            else:
                r.finish = t
        while live:
            l_d = float(self.cost.decode_latency(c, len(live)))
            t += l_d
            nxt: List[tuple[Request, int, int]] = []
            for r, remaining, cap in live:
                if l_d > r.tbt_slo + 1e-12:
                    r.tbt_violations += 1
                self.tokens_served += 1
                if remaining - 1 > 0:
                    if spec and cap <= 1:
                        # cancel-on-overrun: budget spent, stream not
                        # done -- drop it from the gang (the slot frees)
                        # and let the runner observe the cancel
                        r.cancelled = True
                        self.overrun_cancels += 1
                        if track:
                            unc.observe(unc.planned_length(r.slo),
                                        float(r.decode_tokens), r.slo)
                    else:
                        nxt.append((r, remaining - 1, cap - 1))
                else:
                    r.finish = t
                    if track:
                        unc.observe(unc.planned_length(r.slo),
                                    float(r.decode_tokens), r.slo)
            live = nxt
        return t


@dataclass
class ServedRequest:
    """A live-backend unit of work: the request, the payload it carried
    (e.g. a token array), and the model output filled in by ``execute``."""
    req: Request
    payload: Any
    result: Any = None


class TorchBackend(_PooledBackend):
    """Live execution over a ``(c, b)`` executable table on the device.

    ``step_fns[(c, b)](stacked_payload)`` must be ready to call (built
    and warmed at deploy -- that is what makes the resize in-place; on
    one device every ``c`` of a ``b`` is the same function).  ``clock``
    selects how virtual time advances after a batch:

    * ``"measured"`` -- by the measured wall latency, device work
      included (the serving default);
    * ``"modeled"``  -- by ``perf.latency(b, c)``, which makes the event
      stream equal to ``SimBackend``'s for the same policy + workload
      *provided both backends charge the same resize_penalty* (the table
      still runs and produces real outputs, and the measured-vs-predicted
      residual is still recorded).  The defaults differ: this backend
      charges 0 (the table flip is free), ``SimBackend`` 5 ms; parity
      runs must set both to 0.

    Multi-slot pools are supported: a horizontal policy (FA2-style) can
    target ``Decision.n`` replicas and each slot executes through the
    table entry for its own core count.  On one card the replicas run
    one after another in wall time while the virtual clock treats them
    as parallel.  Execution and wall-latency measurement go through one
    ``TimedExecutor``, which waits for the device before it reads the
    clock.
    """

    name = "torch"

    def __init__(self, step_fns: Dict[tuple[int, int], Callable],
                 pad_payload: Callable, perf: PerfModel,
                 clock: str = "measured", c0: Optional[int] = None,
                 resize_penalty: float = 0.0):
        if clock not in ("measured", "modeled"):
            raise ValueError(f"clock must be 'measured' or 'modeled', "
                             f"got {clock!r}")
        self.table = TimedExecutor(step_fns)
        self.step_fns = self.table.fns
        self.pad_payload = pad_payload
        self.clock = clock
        self.results: List[ServedRequest] = []
        self.measured: List[tuple[float, int, int, float]] = []
        self._payloads: Dict[int, Any] = {}
        c_set = sorted({c for c, _ in step_fns})
        b_set = sorted({b for _, b in step_fns})
        super().__init__(perf, c_set, b_set, c0=c0 or max(c_set),
                         resize_penalty=resize_penalty)

    def warmup(self, example_payload: Any) -> None:
        self.table.warmup(
            lambda c, b: (self.pad_payload([example_payload] * min(b, 2),
                                           b),))

    def on_submit(self, req: Request, payload: Any) -> None:
        self._payloads[req.id] = payload

    def execute(self, batch: List[Request], c: int, b: int,
                now: float) -> float:
        items = [ServedRequest(r, self._payloads.pop(r.id, None))
                 for r in batch]
        out = self.table(c, b, self.pad_payload(
            [it.payload for it in items], b))
        dt = self.table.calls[-1][3]
        out = _to_host(out)             # one device-to-host copy per batch
        for i, it in enumerate(items):
            it.result = _index_result(out, i)
            self.results.append(it)
        predicted = float(self.perf.latency(b, c))
        self.measured.append((now, c, b, dt))
        if self.monitor is not None:
            self.monitor.observe_perf_residual(predicted, dt)
        return now + (dt if self.clock == "measured" else predicted)


def _to_host(out: Any) -> Any:
    """A step function's output with every tensor copied to a host numpy
    array (dicts, lists and tuples are walked)."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_host(v) for v in out)
    return out


def _index_result(out: Any, i: int):
    """Row ``i`` of every array leaf of a host-side batch output (the
    reference's ``jax.tree.map`` over the output pytree)."""
    if isinstance(out, dict):
        return {k: _index_result(v, i) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_index_result(v, i) for v in out)
    if hasattr(out, "shape") and getattr(out, "ndim", 0) > 0:
        return np.asarray(out)[i]
    return out


@dataclass
class RunReport:
    """Uniform result of a scenario run, backend- and policy-agnostic.
    ``report["p99"]`` reads a field.

    Fields:

    * ``policy`` / ``backend`` — names of the pair that produced the run.
    * ``n_requests`` — requests observed by the monitor (served + dropped).
    * ``n_violations`` — requests finishing after their absolute deadline
      (strictly later than ``deadline + 1e-9``), plus any drops.
    * ``violation_rate`` — ``n_violations / max(n_requests, 1)``.
    * ``core_seconds`` — allocated-core integral over the horizon, resize
      penalties and dead replicas included (the paper's cost axis).
    * ``avg_cores`` — ``core_seconds / horizon``.
    * ``p50`` / ``p99`` / ``mean_latency`` — end-to-end latency statistics
      measured from client *send* time (comm latency included), seconds.
    * ``core_timeline`` — ``(tick_time, allocated_cores)`` samples.
    * ``decisions`` — the policy's ``(time, Decision)`` log when it keeps
      one (None otherwise).
    * ``buckets`` — per dispatched batch: ``(dispatch_time, cores,
      batch_bucket, actual_batch_len)``.

    Token-serving extras (zero/NaN on fixed-work runs):

    * ``tokens_served`` / ``tokens_per_s`` — generated tokens (first
      token + decode stream) and their rate over the horizon.
    * ``ttft_p50`` / ``ttft_p99`` — time-to-first-token percentiles
      measured from client send time, seconds.
    * ``tbt_violation_rate`` — fraction of decode tokens whose gap from
      the previous token exceeded the request's per-token SLO.

    Online-session extra (``repro_torch.serving.session``):

    * ``n_cancelled`` — requests withdrawn mid-flight via
      ``SpongeSession.cancel``; excluded from every served/violation
      aggregate (0 on closed-world replays).

    Degradation extras (``core.degradation`` fleets; NaN/0/None on
    single-model runs):

    * ``accuracy_goodput`` — accuracy-weighted goodput: the sum of the
      serving model's accuracy score over requests served *within* their
      deadline, divided by the horizon (Orloj's objective — a degraded
      answer in time beats a full-accuracy answer that is late, but
      counts for less than a full-accuracy answer in time).
    * ``mean_served_accuracy`` — mean accuracy score over served
      requests (degradation depth, independent of the rate axis).
    * ``model_swaps`` — committed model swaps over the run.
    * ``model_timeline`` — ``(t, rung_name, accuracy)`` resident-model
      segments (first entry at t=0).
    """
    policy: str
    backend: str
    n_requests: int
    n_violations: int
    violation_rate: float
    core_seconds: float
    avg_cores: float
    p50: float
    p99: float
    mean_latency: float
    core_timeline: List[tuple]
    decisions: Optional[List[tuple]]
    buckets: List[tuple]
    tokens_served: int = 0
    tokens_per_s: float = 0.0
    ttft_p50: float = float("nan")
    ttft_p99: float = float("nan")
    tbt_violation_rate: float = 0.0
    n_cancelled: int = 0
    accuracy_goodput: float = float("nan")
    mean_served_accuracy: float = float("nan")
    model_swaps: int = 0
    model_timeline: Optional[List[tuple]] = None

    def __getitem__(self, key: str):
        return getattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def keys(self):
        return [f.name for f in dataclasses.fields(self)]

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}



def build_array_report(policy, backend: str, batch, finish: np.ndarray,
                       horizon: float, slots, core_samples,
                       bucket_log, n_cancelled: int = 0) -> RunReport:
    """The ONE report aggregation of the struct-of-arrays engines
    (``fastpath.FastSimRunner``, the vector engine and both ``fleet``
    runners): served mask over the ``finish`` column, violations
    strictly past ``deadline + 1e-9``, end-to-end latency from client
    send time, the nearest-rank percentile rule, and the per-slot
    core-seconds integral clamped to each slot's release point.  Centralized so the acceptance metrics
    (the violation epsilon, the percentile indexing) cannot drift
    between engines."""
    served = ~np.isnan(finish)
    fin = finish[served]
    n_req = int(served.sum())
    viol = int((fin > batch.deadline[served] + 1e-9).sum())
    e2e = np.sort(fin - (batch.arrival[served]
                         - batch.comm_latency[served]))
    nn = e2e.size

    def p(q: float) -> float:
        if not nn:
            return float("nan")
        return float(e2e[min(int(q * nn), nn - 1)])

    core_s = 0.0
    for s in slots:
        end = min(s.dead_at if s.dead_at is not None else horizon,
                  horizon)
        s.account(max(end, s.alive_since))
        core_s += s.core_seconds
    decisions = getattr(policy, "decisions", None)
    if decisions is None:
        decisions = getattr(getattr(policy, "scaler", None),
                            "decisions", None)
    return RunReport(
        policy=getattr(policy, "name", type(policy).__name__),
        backend=backend,
        n_requests=n_req,
        n_violations=viol,
        violation_rate=viol / max(n_req, 1),
        core_seconds=core_s,
        avg_cores=core_s / max(horizon, 1e-9),
        p50=p(0.50), p99=p(0.99),
        mean_latency=float(e2e.sum()) / max(nn, 1),
        core_timeline=core_samples,
        decisions=decisions,
        buckets=bucket_log,
        n_cancelled=n_cancelled,
    )


class ScenarioRunner:
    """The single Sponge control loop: request arrivals, adaptation ticks,
    slack-aware EDF dispatch, server-free events — over any
    (policy, backend) pair.

    The event engine lives on the runner's **online session**
    (``repro_torch.serving.session.ExactSession``): arrivals sit on a
    pending heap keyed ``(arrival, submission order)`` while adaptation
    ticks are generated incrementally and only dynamic events (batch
    completions and precise wake-ups, deduplicated per slot) join the
    dynamic heap.

    Dispatch waits to fill the scaler's batch size b and releases a
    partial batch only when the head request's deadline would otherwise
    be at risk (GrandSLAm-style timeout).  Legacy ``on_tick(now, sim)``
    policies receive this runner as ``sim`` and may mutate the pool
    through ``add_server`` / ``remove_servers`` / ``set_batch``;
    decide-protocol policies are driven through :meth:`drive`.

    With a ``trace`` (``serving/trace.py``) each ``decide`` is the span
    ``sponge.decide``, and its session marks ``sponge.admit`` as each
    request enters the queue.
    """

    trace = None

    def __init__(self, policy, backend, tick: float = 1.0,
                 dispatch_margin: float = 0.02):
        self.policy = policy
        self.backend = backend
        self.tick = tick
        self.dispatch_margin = dispatch_margin
        self.queue = EDFQueue()
        self.monitor = Monitor()
        backend.monitor = self.monitor
        self.b = 1
        self.now = 0.0
        self.events_processed = 0
        self.core_samples: List[tuple[float, int]] = []
        self.bucket_log: List[tuple[float, int, int, int]] = []

    # -- facade used by policies (legacy and new) --------------------------
    @property
    def pool(self) -> List[Server]:
        return self.backend.pool

    @property
    def c_set(self) -> Tuple[int, ...]:
        return self.backend.c_set

    @property
    def b_set(self) -> Tuple[int, ...]:
        return self.backend.b_set

    @property
    def allocated_cores(self) -> int:
        return self.backend.allocated_cores

    def add_server(self, c: int, ready_at: float = 0.0) -> Server:
        return self.backend.add_slot(c, ready_at=ready_at, now=self.now)

    def remove_servers(self, n: int, now: float) -> None:
        self.backend.remove_slots(n, now)

    def set_batch(self, b: int) -> None:
        self.b = max(1, int(b))

    def apply_decision(self, d: Decision, now: float) -> None:
        _, b = resolve_decision(self.backend.c_set, d)
        self.set_batch(b)
        self.backend.apply(d, now)

    def drive(self, policy, now: float) -> None:
        """Run one adaptation step of a decide-protocol policy."""
        due = policy.due(now) if hasattr(policy, "due") else True
        if not due:
            return
        lam = self.monitor.rate.rate(now)
        wait0 = max(self.pool[0].busy_until - now, 0.0)
        with span(self.trace, "decide") as rec:
            d = policy.decide(now, self.queue, lam, initial_wait=wait0)
        if rec is not None:
            rec.attrs["c"], rec.attrs["b"] = resolve_decision(
                self.backend.c_set, d)
        self.apply_decision(d, now)

    def submit(self, req: Request, payload: Any = None) -> None:
        self.monitor.observe_arrival(req)
        self.queue.push(req)
        self.backend.on_submit(req, payload)

    # -- main loop ---------------------------------------------------------
    def session(self):
        """Open an online session on this runner (``submit`` /
        ``update_slo`` / ``cancel`` / ``step_until`` — see
        ``repro_torch.serving.session``).  One session per runner."""
        from repro_torch.serving.session import ExactSession
        return ExactSession(self)

    def run(self, arrivals, horizon: Optional[float] = None) -> RunReport:
        """``arrivals``: Requests, (Request, payload) pairs for live
        backends, or a ``RequestBatch`` (materialized on entry).  Runs the
        event loop to ``horizon`` (default: last arrival + 60 s) in
        virtual time and returns a RunReport.

        This is a thin replay driver over :meth:`session`: every arrival
        is submitted up front (onto the session's pending heap) and the
        session drains to the horizon.  The event cursor merges the
        pending arrivals, the incremental tick train and the dynamic
        completion/wake-up heap with the same total order the reference
        loop produces: time ascending; at equal times arrivals, then
        ticks, then dynamic events in push order.  Every event is
        followed by one dispatch pass.
        """
        from repro_torch.serving.workload import RequestBatch
        if isinstance(arrivals, RequestBatch):
            arrivals = arrivals.to_requests()
        norm = [(a, None) if isinstance(a, Request) else (a[0], a[1])
                for a in arrivals]
        norm.sort(key=lambda p: p[0].arrival)   # stable: ties keep order
        if horizon is None:
            horizon = norm[-1][0].arrival + 60.0 if norm else 60.0
        sess = self.session()
        for req, payload in norm:
            sess.submit(req, payload=payload)
        return sess.finish(horizon)

    def _dispatch(self, t: float, events, seq) -> None:
        queue = self.queue
        if not len(queue):
            return
        for srv in self.pool:
            if srv.ready_at > t or srv.busy_until > t:
                # a slot busy (or cold-starting) past this event with
                # queued work gets a precise wake-up: a resize penalty can
                # extend busy_until beyond the slot's scheduled "free"
                # event, which would otherwise strand the queue until the
                # next tick
                wake_t = max(srv.ready_at, srv.busy_until)
                if self._wake.get(srv.id) != wake_t:
                    self._wake[srv.id] = wake_t
                    heapq.heappush(events,
                                   (wake_t, next(seq), "check", srv.id))
                continue
            while len(queue) and srv.ready_at <= t and srv.busy_until <= t:
                q = len(queue)
                if q < self.b:
                    head = queue.peek()
                    l_full = srv.instance.latency(self.b)
                    t_force = head.deadline - l_full - self.dispatch_margin
                    if t < t_force:
                        # re-check when deadline pressure bites (new
                        # arrivals also re-trigger dispatch); dedup per
                        # slot so a waiting server schedules one wake-up
                        tw = min(t_force, t + self.tick)
                        if self._slack_wake.get(srv.id) != tw:
                            self._slack_wake[srv.id] = tw
                            heapq.heappush(events,
                                           (tw, next(seq), "check", srv.id))
                        break
                batch = queue.pop_batch(self.b)
                bucket = srv.instance.bucket_b(len(batch))
                fin = self.backend.execute(batch, srv.instance.c, bucket, t)
                srv.busy_until = fin
                self.bucket_log.append((t, srv.instance.c, bucket,
                                        len(batch)))
                for r in batch:
                    r.start_proc = t
                    if r.cancelled:
                        # cancel-on-overrun (speculative token backend):
                        # retract λ, count in n_cancelled, keep it out
                        # of every aggregate
                        self.monitor.observe_cancel(r)
                        continue
                    if r.finish is None:   # phase-aware backends record
                        r.finish = fin     # per-request finishes themselves
                    self.monitor.observe_completion(r)
                heapq.heappush(events, (fin, next(seq), "free", srv.id))

    def results(self, horizon: float) -> RunReport:
        mon = self.monitor
        total_core_s = self.backend.core_seconds(horizon)
        lat = mon.e2e_latencies()
        decisions = getattr(self.policy, "decisions", None)
        if decisions is None:
            decisions = getattr(getattr(self.policy, "scaler", None),
                                "decisions", None)
        token_kw = {}
        streamed = [r for r in mon.completed if r.first_token is not None]
        if streamed:
            ttft = sorted(r.first_token - (r.arrival - r.comm_latency)
                          for r in streamed)
            tokens = sum(1 + r.decode_tokens for r in streamed)
            dec_tokens = sum(r.decode_tokens for r in streamed)
            tbt_viol = sum(r.tbt_violations for r in streamed)
            token_kw = dict(
                tokens_served=tokens,
                tokens_per_s=tokens / max(horizon, 1e-9),
                ttft_p50=ttft[min(int(0.50 * len(ttft)), len(ttft) - 1)],
                ttft_p99=ttft[min(int(0.99 * len(ttft)), len(ttft) - 1)],
                tbt_violation_rate=tbt_viol / max(dec_tokens, 1))
        return RunReport(
            policy=getattr(self.policy, "name", type(self.policy).__name__),
            backend=getattr(self.backend, "name", "?"),
            n_requests=mon.n_total,
            n_violations=mon.n_violations,
            violation_rate=mon.violation_rate,
            core_seconds=total_core_s,
            avg_cores=total_core_s / max(horizon, 1e-9),
            p50=mon.p(0.50), p99=mon.p(0.99),
            mean_latency=sum(lat) / max(len(lat), 1),
            core_timeline=self.core_samples,
            decisions=decisions,
            buckets=self.bucket_log,
            n_cancelled=mon.n_cancelled,
            **token_kw,
        )


# --------------------------------------------------------------------------
# facade + config-driven construction
# --------------------------------------------------------------------------
class SpongeServer:
    """Facade composing SchedulingPolicy + ExecutionBackend + the runner."""

    def __init__(self, policy, backend, tick: float = 1.0,
                 dispatch_margin: float = 0.02, prior_rps: float = 0.0):
        self.policy = policy
        self.backend = backend
        self.runner = ScenarioRunner(policy, backend, tick=tick,
                                     dispatch_margin=dispatch_margin)
        self.runner.monitor.rate.prior_rps = prior_rps

    @property
    def monitor(self) -> Monitor:
        return self.runner.monitor

    @property
    def queue(self) -> EDFQueue:
        return self.runner.queue

    @property
    def pool(self) -> List[Server]:
        return self.backend.pool

    def warmup(self, example_payload: Any) -> None:
        self.backend.warmup(example_payload)

    def session(self):
        """Open an online session on the composed runner (``submit`` /
        ``update_slo`` / ``cancel`` / ``step_until`` -- the live-client
        surface; see ``repro_torch.serving.session``)."""
        return self.runner.session()

    def run(self, arrivals: Sequence, horizon: Optional[float] = None
            ) -> RunReport:
        return self.runner.run(arrivals, horizon)

    def serve(self, workload: WorkloadGenerator, trace,
              duration: Optional[float] = None,
              horizon: Optional[float] = None) -> RunReport:
        """Generate a workload against a bandwidth trace and run it."""
        return self.run(workload.generate(trace, duration), horizon)


POLICY_NAMES = ("sponge", "sponge-pred", "fa2", "static-8", "static-16",
                "static-<cores>")


def make_policy(name: str, perf: PerfModel, *,
                c_set: Sequence[int] = DEFAULT_C,
                b_set: Sequence[int] = DEFAULT_B,
                adaptation_interval: float = 1.0,
                slo: float = 1.0, expected_rps: float = 0.0,
                **kw):
    """Policy registry: one name -> one SchedulingPolicy instance."""
    if name == "sponge":
        return SpongePolicy(SpongeScaler(
            perf, c_set=tuple(c_set), b_set=tuple(b_set),
            adaptation_interval=adaptation_interval, **kw))
    if name == "sponge-pred":
        return PredictivePolicy(PredictiveSpongeScaler(
            perf, c_set=tuple(c_set), b_set=tuple(b_set),
            adaptation_interval=adaptation_interval, **kw))
    if name == "fa2":
        return FA2Policy(perf, slo=slo, b_set=tuple(b_set),
                         expected_rps=expected_rps, **kw)
    if name.startswith("static"):
        cores = int(name.split("-")[1]) if "-" in name else 16
        return StaticPolicy(perf, cores=cores, b_set=tuple(b_set),
                            interval=adaptation_interval, **kw)
    raise KeyError(f"unknown policy {name!r}; known: {POLICY_NAMES}")


def make_sim_server(perf: Optional[PerfModel] = None,
                    policy="sponge", *,
                    c_set: Sequence[int] = DEFAULT_C,
                    b_set: Sequence[int] = DEFAULT_B,
                    c0: int = 1, tick: float = 1.0,
                    prior_rps: float = 0.0,
                    resize_penalty: float = 0.005,
                    dispatch_margin: float = 0.02,
                    **policy_kw) -> SpongeServer:
    """Simulation server: calibrated PerfModel backend + named policy."""
    perf = perf if perf is not None else yolov5s_like()
    pol = (make_policy(policy, perf, c_set=c_set, b_set=b_set, **policy_kw)
           if isinstance(policy, str) else policy)
    backend = SimBackend(perf, c_set, b_set, c0=c0,
                         resize_penalty=resize_penalty)
    return SpongeServer(pol, backend, tick=tick,
                        dispatch_margin=dispatch_margin, prior_rps=prior_rps)


# --------------------------------------------------------------------------
# the live executable table
# --------------------------------------------------------------------------
def calibrate_step_fns(fns: Dict[tuple[int, int], Callable],
                       example_for: Callable[[int, int], Any],
                       robust: bool = False) -> PerfModel:
    """Profile every (c, b) executable once and fit the paper's l(b, c).

    The table is warmed first (one call per distinct function); each
    timed call ends when the device has finished (``TimedExecutor``).
    On one device ``dt`` does not depend on ``c``, so the ``b/c`` and
    ``1/c`` coefficients are fitted to noise, as on the reference's CPU.
    """
    table = TimedExecutor(fns)
    table.warmup(lambda c, b: (example_for(c, b),))
    for (c, b) in fns:
        table(c, b, example_for(c, b))
    return PerfModel.fit([(b, c, dt) for _, c, b, dt in table.calls],
                         robust=robust)


def build_llm_step_fns(model, params, c_set: Sequence[int],
                       b_set: Sequence[int], prompt_len: int,
                       gen_tokens: int = 8, capture: Optional[bool] = None):
    """Executable table for short-generation LLM serving: each entry
    prefills the (b, prompt_len) prompt batch and runs ``gen_tokens``
    greedy decode steps, returning their ids as a (b, gen_tokens) int32
    tensor on the model's device (the prefill's own argmax seeds the
    first step and is not returned, as in the reference).

    Between its first launch and its return an entry reads nothing back
    to the host: the argmax stays on the device and the ids are stacked
    there.  So each b's entry is one :class:`CapturedStep` over a static
    prompt buffer and a static cache: on the card the whole entry,
    prefill, decode steps, argmaxes and id stack, is one CUDA graph,
    captured at its first call (the warm-up) when ``capture`` (the
    default on a CUDA device), and eager otherwise.  The ids returned
    are a copy, which a later call does not overwrite.  Every c shares
    one function per b (see ``TorchBackend``).
    """
    cache_len = prompt_len + gen_tokens
    vocab = model.cfg.vocab_size
    device = model.device

    def make(b):
        with torch.inference_mode():
            cache = model.init_cache(b, cache_len)
            tokens = torch.zeros((b, prompt_len), dtype=torch.int32,
                                 device=device)

        def body():
            logits, _ = model.prefill(params, {"tokens": tokens},
                                      cache=cache)
            tok = torch.argmax(logits[:, :vocab], dim=-1)
            tok = tok.to(torch.int32)[:, None]
            out = []
            for _ in range(gen_tokens):
                lg, _ = model.decode_step(params, cache, tok)
                tok = torch.argmax(lg[:, :vocab], dim=-1)
                tok = tok.to(torch.int32)[:, None]
                out.append(tok)
            return torch.cat(out, dim=1)

        step = CapturedStep(body, (tokens,), capture)

        def fn(prompts):
            with torch.inference_mode():
                return step(prompts).clone()

        fn.step = step
        return fn

    fns = {}
    for b in b_set:
        entry = make(b)
        for c in c_set:
            fns[(c, b)] = entry
    return fns


def pad_tokens(payloads: List[np.ndarray], b: int) -> np.ndarray:
    """Stack int32 token payloads to the batch bucket ``b``, repeating
    the last entry as padding."""
    x = np.stack(payloads + [payloads[-1]] * (b - len(payloads)))
    return x.astype(np.int32)


def make_live_server(arch: str = "smollm-135m-reduced", *,
                     c_set: Sequence[int] = (1, 2, 4, 8),
                     b_set: Sequence[int] = (1, 2, 4, 8),
                     prompt_len: int = 16, gen_tokens: int = 8,
                     policy="sponge", adaptation_interval: float = 0.5,
                     prior_rps: float = 0.0, clock: str = "measured",
                     perf: Optional[PerfModel] = None,
                     tick: Optional[float] = None,
                     params: Optional[dict] = None, seed: int = 0,
                     device=None, **policy_kw):
    """Live server on the Hopper kernels.

    Resolves ``arch`` through ``configs.registry`` with both kernel
    routes on (the port's route breadth; the reference's default config
    runs plain attention here), builds the model on ``device`` (``cuda``
    unless named) with ``params`` (e.g. from ``params_from_jax``) or
    random weights drawn from ``seed``, builds and warms the (c, b)
    table, calibrates a ``PerfModel`` from it unless ``perf`` is given,
    and wires the named policy + ``TorchBackend`` behind a
    ``SpongeServer``.  Returns ``(server, model_config)``.
    """
    cfg = dataclasses.replace(get_config(arch), use_pallas_prefill=True,
                              use_pallas_decode=True)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(model.generator(seed))
    fns = build_llm_step_fns(model, params, c_set, b_set, prompt_len,
                             gen_tokens=gen_tokens)

    def example(c, b):
        return np.ones((b, prompt_len), np.int32)

    if perf is None:
        perf = calibrate_step_fns(fns, example)
    else:
        TimedExecutor(fns).warmup(lambda c, b: (example(c, b),))
    pol = (make_policy(policy, perf, c_set=c_set, b_set=b_set,
                       adaptation_interval=adaptation_interval, **policy_kw)
           if isinstance(policy, str) else policy)
    backend = TorchBackend(fns, pad_tokens, perf, clock=clock)
    server = SpongeServer(
        pol, backend,
        tick=tick if tick is not None else adaptation_interval,
        prior_rps=prior_rps)
    return server, cfg


# --------------------------------------------------------------------------
# tiny executable table for smoke tests and parity tests
# --------------------------------------------------------------------------
def toy_step_fns(c_set: Sequence[int], b_set: Sequence[int],
                 dim: int = 32, seed: int = 0, device=None):
    """Minimal (c, b) table -- a tanh layer over the reference's numpy
    weights -- for exercising ``TorchBackend`` cheaply.  Every c shares
    the same function, exactly like ``build_llm_step_fns``."""
    dev = resolve_device(device)
    w = torch.as_tensor(np.random.default_rng(seed)
                        .standard_normal((dim, dim)) / np.sqrt(dim),
                        dtype=torch.float32, device=dev)

    def make(_b):
        @torch.inference_mode()
        def fn(x):
            return torch.tanh(torch.as_tensor(x, device=dev) @ w)
        return fn

    fns = {}
    for b in b_set:
        entry = make(b)
        for c in c_set:
            fns[(c, b)] = entry
    return fns


def pad_vectors(payloads: List[np.ndarray], b: int) -> np.ndarray:
    """Stack float payloads to the batch bucket ``b``, repeating the last
    entry as padding (the toy-table counterpart of ``pad_tokens``)."""
    x = np.stack(list(payloads) + [payloads[-1]] * (b - len(payloads)))
    return x.astype(np.float32)
