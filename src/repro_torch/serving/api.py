"""The Sponge serving control plane: slot pool, runner and report.

Copy of ``repro.serving.api`` cut to what the token path uses: the
decision-application rule (``round_up_c`` / ``resolve_decision``), the
vertically scalable slot pool (``Server``, ``_PooledBackend``), the
uniform ``RunReport`` and the one event loop, ``ScenarioRunner``.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.core.monitor import Monitor
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.queueing import EDFQueue
from repro_torch.core.slo import Decision, Request
from repro_torch.core.vertical import VerticalScaledInstance

_sid = itertools.count()


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


@dataclass
class RunReport:
    """Uniform result of a scenario run, backend- and policy-agnostic.
    ``report["p99"]`` reads a field.

    Fields:

    * ``policy`` / ``backend`` — names of the pair that produced the run.
    * ``n_requests`` — requests served.
    * ``n_violations`` — requests finishing after their absolute deadline
      (strictly later than ``deadline + 1e-9``).
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

    def __getitem__(self, key: str):
        return getattr(self, key)



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
    """

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
        d = policy.decide(now, self.queue, lam, initial_wait=wait0)
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
