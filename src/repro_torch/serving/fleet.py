"""The fleet layer: joint horizontal + vertical scaling over N replicas.

Copy of ``repro.serving.fleet``, NumPy only, as the reference.  Sponge
scopes itself to in-place vertical scaling of a single instance;
its follow-up ("A Tale of Two Scales", Razavi et al. 2024) shows the
real win is reconciling vertical with horizontal replica scaling under
one cost model, and Orloj (Yu et al. 2022) shows per-replica
deadline-aware dispatch is what keeps tail SLOs honest at fleet scale.
This module is that layer on top of the single-replica control plane:

* :class:`FleetReplica` — one replica: a vertically scalable core count,
  its **own EDF queue** (per-replica dispatch, not a shared global
  queue), availability/cold-start state, and core-second accounting.
* **Routers** (:func:`route_request`) — pluggable arrival routing across
  admitting replicas: ``least-loaded`` (shortest queue, busy replicas
  penalized), ``jsq`` (join-shortest-queue) and ``edf-deadline``
  (Orloj-style: join the replica where the new request has the fewest
  earlier-deadline requests ahead of it).
* :class:`FleetSpongeScaler` — the joint scaler: every adaptation
  interval it snapshots the *global* queue state and solves the joint
  ``(n, c, b)`` IP (``core.solver.JointMemoizedSolver``) that
  minimizes total core allocation ``n*c`` subject to every request's
  dynamic SLO.  Scale-ups take effect immediately (new replicas pay a
  cold start); **scale-downs are hysteretic** — the lower replica target
  must persist for ``down_patience`` consecutive decisions, and in the
  meantime ``(c, b)`` re-solves with ``n`` pinned at the current fleet
  size, so a transient lull sheds cores vertically before it sheds
  replicas.
* **Scale-down drain** — a retiring replica stops admitting, its queued
  requests re-route to the survivors through the same router (EDF
  order), it finishes its in-flight batch, and only then releases its
  cores (``dead_at = max(now, busy_until)`` bounds the core-second
  integral).
* Two event engines, one semantics: :class:`FleetFastSimRunner` (the
  struct-of-arrays engine — streamed arrivals/ticks/fleet events, bare
  ``(deadline, index)`` queues, ≥500k requests/run across ≥8 replicas,
  the reference's fleet benchmark) and :class:`FleetExactRunner` (the
  exact gang loop: every event pre-heaped, ``Request`` objects,
  object-based EDF queues — the decision-identity oracle
  the fleet tests hold the fast engine to).

Fleet disruptions (``replica-failure`` / ``rolling-restart`` scenarios)
arrive as **fleet events**: ``(t, "kill", i)`` retires the i-th active
replica abruptly (in-flight batch completes, queue re-routes, cores
release — fail-stop after the current batch), ``(t, "restart", i,
delay)`` does the same but immediately spawns a replacement that cold
starts for ``delay`` seconds.  Recovery is the scaler's job: the next
adaptation tick sees the shrunken fleet and re-targets ``n``.

The fast engine's event loop lives on the online session
(``serving.session.FleetSession`` — mid-flight ``update_slo``
re-routes tightened budgets through the arrival router, ``cancel``
excises queued work) and ``FleetFastSimRunner.run`` is its
no-renegotiation replay; ``FleetExactRunner`` keeps the pre-heaped
closed-world gang loop as the decision-identity oracle.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import bisect_left, insort
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.monitor import (accuracy_weighted_goodput,
                                array_window_rate, tick_window_rate)
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.queueing import EDFQueue, FastEDFQueue
from repro_torch.core.slo import Decision
from repro_torch.core.solver import (DEFAULT_B, DEFAULT_C, DEFAULT_N,
                               JointMemoizedSolver)
from repro_torch.serving.api import (RunReport, build_array_report,
                               resolve_decision)
from repro_torch.serving.fastpath import build_bucket_array
from repro_torch.serving.workload import RequestBatch

ROUTERS = ("least-loaded", "jsq", "edf-deadline")


class FleetReplica:
    """One fleet replica as plain scalars + its own EDF queue.

    The queue substrate differs by engine (``FastEDFQueue`` of bare
    ``(deadline, index)`` pairs on the fast path, ``EDFQueue`` of
    ``Request`` objects on the exact gang loop) but both expose
    ``_heap`` with ``item[0]`` the absolute deadline, which is all the
    routers and the dispatch pass read.  Core-second accounting is the
    same monotone integral as ``serving.fastpath._Slot``.
    """

    __slots__ = ("id", "c", "ready_at", "busy_until", "alive_since",
                 "dead_at", "core_seconds", "_last_t", "queue", "dls")

    def __init__(self, rid: int, c: int, ready_at: float, now: float,
                 queue):
        self.id = rid
        self.c = c
        self.ready_at = ready_at
        self.busy_until = 0.0
        self.alive_since = now
        self.dead_at: Optional[float] = None
        self.core_seconds = 0.0
        self._last_t: Optional[float] = now
        self.queue = queue
        # sorted mirror of the queued deadlines, maintained at every
        # push/pop alongside the heap: lets the edf-deadline router count
        # a newcomer's EDF position with one bisect instead of scanning
        # the whole heap per arrival (O(total backlog) per request turns
        # the overloaded phases of a 500k-request run quadratic)
        self.dls: List[float] = []

    def account(self, now: float) -> None:
        """Integrate allocated core-seconds up to ``now``."""
        if now > self._last_t:
            self.core_seconds += self.c * (now - self._last_t)
            self._last_t = now


def route_request(router: str, replicas: Sequence[FleetReplica],
                  deadline: float, now: float,
                  cold_load=None) -> int:
    """Pick the replica (index into ``replicas``) a new arrival joins.

    All keys tie-break on list position (creation order), so routing is
    deterministic and identical across the fast and exact engines:

    * ``least-loaded`` — lowest load, where load is queue length plus one
      slot for a busy replica plus the replica's remaining cold-start
      time converted to queue-slot equivalents (``cold_load``) — a
      replica still booting only attracts work once the warm queues are
      deeper than its boot time is long;
    * ``jsq``          — join-shortest-queue, queue length only (the
      classic baseline, deliberately cold-start-blind);
    * ``edf-deadline`` — deadline-aware (Orloj-style): join the replica
      where the fewest queued requests have an *earlier* deadline than
      the newcomer (the newcomer's EDF position, cold-start adjusted),
      then shortest queue.  Counted with one bisect into each replica's
      sorted deadline mirror (``FleetReplica.dls``), not a heap scan —
      O(R log q) per arrival even when an overload spike piles tens of
      thousands of requests into the queues.

    ``cold_load`` maps a replica to its cold-start penalty in fractional
    queue slots (the runners pass remaining boot seconds divided by the
    replica's per-request service time); ``None`` disables the term.
    """
    best = 0
    best_key: Optional[tuple] = None
    for i, r in enumerate(replicas):
        qn = len(r.queue)               # live entries only (renegotiation
        cold = cold_load(r) if cold_load is not None else 0.0   # safe)
        if router == "least-loaded":
            busy = 1 if (r.busy_until > now or r.ready_at > now) else 0
            key = (qn + busy + cold, i)
        elif router == "jsq":
            key = (qn, i)
        elif router == "edf-deadline":
            ahead = bisect_left(r.dls, deadline)
            key = (ahead + cold, qn, i)
        else:
            raise KeyError(f"unknown router {router!r}; known: {ROUTERS}")
        if best_key is None or key < best_key:
            best_key = key
            best = i
    return best


# --------------------------------------------------------------------------
# fleet scheduling policies
# --------------------------------------------------------------------------
class _JointPolicyBase:
    """Shared fleet-policy plumbing: the adaptation-cadence gate and the
    lazily built joint memoized solver — one copy, so the sponge scaler
    and the static baseline it is benchmarked against cannot drift on
    the cadence epsilon or the cache-stats shape.  Subclasses provide
    ``_make_memo()`` and set ``_next_t`` in ``decide_fleet``."""

    def due(self, now: float) -> bool:
        """Adaptation-interval gate (same cadence rule as SpongeScaler)."""
        return now + 1e-12 >= self._next_t

    def _make_memo(self) -> JointMemoizedSolver:  # pragma: no cover
        raise NotImplementedError

    @property
    def memo(self) -> JointMemoizedSolver:
        """The lazily built memoized joint solver."""
        if self._memo is None:
            self._memo = self._make_memo()
        return self._memo

    def solver_stats(self) -> dict:
        """Cache economics of the memoized joint solver."""
        if self._memo is None:
            return {}
        return {"hits": self._memo.hits, "misses": self._memo.misses,
                "hit_rate": self._memo.hit_rate}


@dataclass
class FleetSpongeScaler(_JointPolicyBase):
    """The joint (n, c, b) Sponge scaler with scale-down hysteresis.

    Every adaptation interval: snapshot the global EDF budgets, solve
    the joint IP (minimum total cores ``n*c``), and emit a
    :class:`~repro_torch.core.slo.Decision` carrying the replica target
    ``n``.
    Scale-ups are immediate (the Decision carries ``scale_up_delay`` —
    the cold start new replicas pay); a scale-down must persist for
    ``down_patience`` consecutive decisions before it is emitted — until
    then ``(c, b)`` re-solves with ``n`` pinned at the current fleet
    size, so transient lulls shed cores in place (the cheap axis)
    instead of churning replicas.  Quanta at 0 keep the memoized joint
    solver exact (the decision-identity configuration); positive quanta
    are the conservative production bucketing
    (the reference's fleet benchmark).
    """
    perf: Union[PerfModel, CostModel]
    name: str = "sponge-fleet"
    c_set: Sequence[int] = DEFAULT_C
    b_set: Sequence[int] = DEFAULT_B
    n_set: Sequence[int] = DEFAULT_N
    adaptation_interval: float = 1.0
    # wider margins than the single-replica SpongeScaler: the joint
    # solver plans a perfectly balanced striped split, real routers
    # approximate it, and the gap eats into both budgets
    headroom: float = 0.15              # latency safety margin (seconds)
    lam_headroom: float = 1.3           # provision for lam * this factor
    budget_quantum: float = 0.0
    lam_quantum: float = 0.0
    # per-replica core-equivalent overhead in the joint objective: keeps
    # the solver vertical-first instead of sharding into 1-core replicas
    # whose thin latency margins amplify routing imbalance
    replica_pen: float = 1.0
    scale_up_delay: float = 2.0         # cold start of a new replica (s)
    down_patience: int = 5              # consecutive lower-n decisions
    # total-core ceiling imposed from above (multi-tenant pool slice);
    # None = unconstrained, the single-tenant fleet behaviour
    core_cap: Optional[int] = None
    decisions: List[tuple] = field(default_factory=list)
    _next_t: float = 0.0
    _down_streak: int = 0
    _memo: Optional[JointMemoizedSolver] = field(default=None, repr=False)

    def _make_memo(self) -> JointMemoizedSolver:
        return JointMemoizedSolver(
            self.perf, self.c_set, self.b_set, self.n_set,
            budget_quantum=self.budget_quantum,
            lam_quantum=self.lam_quantum,
            replica_pen=self.replica_pen)

    def _solve_full(self, rem: np.ndarray, lam_eff: float,
                    initial_wait: float) -> Decision:
        """The unconstrained joint solve (degradation subclasses widen
        this to the (m, n, c, b) search)."""
        return self.memo.solve(rem, lam_eff, initial_wait=initial_wait,
                               max_cores=self.core_cap)

    def _solve_pinned_n(self, d: Decision, rem: np.ndarray, lam_eff: float,
                        initial_wait: float, pin: int) -> Decision:
        """The hysteresis-hold re-solve at a pinned replica count
        (degradation subclasses additionally pin the model to ``d.m``)."""
        return self.memo.solve(rem, lam_eff, initial_wait=initial_wait,
                               only_n=pin, max_cores=self.core_cap)

    def _model_gate(self, d: Decision, rem: np.ndarray, lam_eff: float,
                    initial_wait: float) -> Decision:
        """Model-swap hysteresis hook — identity for the single-model
        scaler."""
        return d

    def decide_fleet(self, now: float, remaining: np.ndarray, lam: float,
                     initial_wait: float = 0.0,
                     active_n: int = 1) -> Decision:
        """One adaptation step over the global queue snapshot."""
        self._next_t = now + self.adaptation_interval
        rem = np.maximum(np.asarray(remaining, np.float64) - self.headroom,
                         0.0)
        lam_eff = lam * self.lam_headroom
        d = self._solve_full(rem, lam_eff, initial_wait)
        d = self._model_gate(d, rem, lam_eff, initial_wait)
        if d.n < active_n:
            self._down_streak += 1
            if self._down_streak < self.down_patience:
                # hysteresis: hold the fleet size and re-solve (c, b) at
                # the nearest n_set entry NOT ABOVE it — active_n can sit
                # outside a sparse n_set right after a kill event, and a
                # smaller assumed n makes the (c, b) re-solve strictly
                # more conservative (tighter drain + throughput)
                fits = [n for n in self.n_set if n <= active_n]
                pin = max(fits) if fits else min(self.n_set)
                held = self._solve_pinned_n(d, rem, lam_eff, initial_wait,
                                            pin)
                d = replace(held, n=active_n)
            else:
                self._down_streak = 0
        else:
            self._down_streak = 0
        if d.n > active_n and self.scale_up_delay:
            d = replace(d, scale_up_delay=self.scale_up_delay)
        self.decisions.append((now, d))
        return d


@dataclass
class DegradingFleetScaler(FleetSpongeScaler):
    """The (m, n, c, b) scaler: model size as the third scaling axis.

    Wraps the joint fleet scaler around a
    :class:`~repro_torch.core.degradation.ModelLadder`: every adaptation
    interval the :class:`~repro_torch.core.solver.MultiModelMemoizedSolver`
    searches rungs accuracy-descending, so accuracy is **shed only
    when no (n, c, b) at the resident model is feasible**, never below
    ``accuracy_floor``.  The search is swap-cost-aware — a non-resident
    rung's feasibility is checked with its weights-load time added to
    the initial wait — and model swaps are hysteretic the same way
    scale-downs are: a proposed swap must persist for a run of
    consecutive decisions (same target rung) before it is emitted;
    until then (n, c, b) re-solves with ``m`` pinned at the resident
    model, which reduces bit-identically to the joint solver.
    The patience is asymmetric: a *shed* (accuracy-decreasing swap)
    commits after ``shed_patience`` proposals — it protects the SLO,
    and every held tick grows the backlog — while a *recovery*
    (accuracy-increasing swap) waits the longer ``swap_patience``,
    because recovering onto a rung that is only marginally feasible
    flips straight back and pays two weights loads for nothing.

    The emitted :class:`~repro_torch.core.slo.Decision` carries the target
    rung in ``d.m``; the fleet runners apply the swap with
    drain-before-swap semantics (in-flight batches finish on the old
    model, the weights-load penalty blocks new dispatch — see
    ``_FleetRunnerBase._apply``).
    """
    ladder: Optional[object] = None      # ModelLadder (required)
    accuracy_floor: float = 0.0
    swap_patience: int = 6               # recovery (accuracy-up) patience
    shed_patience: int = 2               # shed (accuracy-down) patience
    m0: Optional[str] = None             # initial resident rung
    name: str = "sponge-degrade"
    _swap_streak: int = 0
    _swap_target: Optional[str] = None

    def __post_init__(self):
        if self.ladder is None:
            raise ValueError("DegradingFleetScaler needs a ModelLadder")
        self.model = (self.m0 if self.m0 is not None
                      else self.ladder.best(self.accuracy_floor).name)
        self.ladder.rung(self.model)     # validate m0

    def _make_memo(self):
        from repro_torch.core.solver import MultiModelMemoizedSolver
        return MultiModelMemoizedSolver(
            self.ladder, self.c_set, self.b_set, self.n_set,
            budget_quantum=self.budget_quantum,
            lam_quantum=self.lam_quantum,
            replica_pen=self.replica_pen)

    def _solve_full(self, rem: np.ndarray, lam_eff: float,
                    initial_wait: float) -> Decision:
        return self.memo.solve(rem, lam_eff, initial_wait=initial_wait,
                               max_cores=self.core_cap,
                               accuracy_floor=self.accuracy_floor,
                               current_m=self.model)

    def _solve_pinned_n(self, d: Decision, rem: np.ndarray, lam_eff: float,
                        initial_wait: float, pin: int) -> Decision:
        # the n-hysteresis hold also holds the (already model-gated)
        # rung, so a held decision never smuggles a swap past the gate
        return self.memo.solve(rem, lam_eff, initial_wait=initial_wait,
                               only_n=pin, max_cores=self.core_cap,
                               accuracy_floor=self.accuracy_floor,
                               m_set=(d.m,), current_m=self.model)

    def _model_gate(self, d: Decision, rem: np.ndarray, lam_eff: float,
                    initial_wait: float) -> Decision:
        """``down_patience``-style hysteresis on the model axis: commit
        a swap only after enough consecutive decisions propose the
        *same* target rung (``shed_patience`` for accuracy-decreasing
        swaps, ``swap_patience`` for recoveries); hold the resident
        model (full re-solve with ``m`` pinned) in the meantime."""
        if d.m == self.model:
            self._swap_streak, self._swap_target = 0, None
            return d
        if d.m == self._swap_target:
            self._swap_streak += 1
        else:
            self._swap_streak, self._swap_target = 1, d.m
        patience = (self.shed_patience
                    if (self.ladder.accuracy(d.m)
                        < self.ladder.accuracy(self.model))
                    else self.swap_patience)
        if self._swap_streak >= patience:
            self._swap_streak, self._swap_target = 0, None
            self.model = d.m             # commit; runners pay the load
            return d
        held = self.memo.solve(rem, lam_eff, initial_wait=initial_wait,
                               max_cores=self.core_cap,
                               accuracy_floor=self.accuracy_floor,
                               m_set=(self.model,), current_m=self.model)
        return held


@dataclass
class StaticFleetPolicy(_JointPolicyBase):
    """The static-fleet baseline: ``replicas`` x ``cores`` pinned, batch
    size via the same joint solver with (n, c) fixed — what a peak-
    provisioned deployment without joint autoscaling looks like (the
    core-seconds baseline the reference's fleet benchmark reports savings
    against)."""
    perf: Union[PerfModel, CostModel]
    replicas: int = 8
    cores: int = 16
    b_set: Sequence[int] = DEFAULT_B
    interval: float = 1.0
    budget_quantum: float = 0.0
    lam_quantum: float = 0.0
    scale_up_delay: float = 2.0         # failure recovery pays a cold start
    name: str = "static-fleet"
    decisions: List[tuple] = field(default_factory=list)
    _next_t: float = 0.0
    _memo: Optional[JointMemoizedSolver] = field(default=None, repr=False)

    def __post_init__(self):
        self.name = f"static-fleet-{self.replicas}x{self.cores}"

    def _make_memo(self) -> JointMemoizedSolver:
        # the joint solver with the (n, c) grid pinned to the static fleet
        return JointMemoizedSolver(
            self.perf, (self.cores,), self.b_set, (self.replicas,),
            budget_quantum=self.budget_quantum,
            lam_quantum=self.lam_quantum)

    def decide_fleet(self, now: float, remaining: np.ndarray, lam: float,
                     initial_wait: float = 0.0,
                     active_n: int = 1) -> Decision:
        """Batch-only adaptation at the pinned fleet shape (replicas
        lost to fleet events are replaced, paying the cold start)."""
        self._next_t = now + self.interval
        d = self.memo.solve(remaining, lam, initial_wait=initial_wait)
        if d.n > active_n and self.scale_up_delay:
            d = replace(d, scale_up_delay=self.scale_up_delay)
        self.decisions.append((now, d))
        return d


# --------------------------------------------------------------------------
# the two fleet engines
# --------------------------------------------------------------------------
def normalize_fleet_events(events) -> List[tuple]:
    """Sort + validate fleet events: ``(t, "kill", i)`` or ``(t,
    "restart", i[, delay])``, time-ascending (stable on ties)."""
    out = []
    for ev in (events or ()):
        t, kind, *args = ev
        if kind not in ("kill", "restart"):
            raise ValueError(f"unknown fleet event kind {kind!r}")
        out.append((float(t), kind, tuple(args)))
    out.sort(key=lambda e: e[0])
    return out


class _FleetRunnerBase:
    """Config + the semantics shared verbatim by both fleet engines:
    routing, decision application, drain/retire, fleet events, the λ
    estimator and reporting.  Only the event-loop organization and the
    queue substrate differ per subclass (that is the point: the exact
    gang loop is the oracle the fast engine is held to)."""

    backend_name = "fleet"

    def __init__(self, policy, perf: Union[PerfModel, CostModel],
                 c_set=DEFAULT_C, b_set=DEFAULT_B, *, n0: int = 1,
                 c0: int = 1, tick: float = 1.0,
                 resize_penalty: float = 0.005,
                 dispatch_margin: float = 0.02, prior_rps: float = 0.0,
                 rate_window: float = 5.0, router: str = "least-loaded",
                 ladder=None, m0: Optional[str] = None):
        if not hasattr(policy, "decide_fleet"):
            raise TypeError(
                f"{type(policy).__name__} has no decide_fleet(); fleet "
                "runners drive fleet policies (FleetSpongeScaler, "
                "StaticFleetPolicy)")
        if router not in ROUTERS:
            raise KeyError(f"unknown router {router!r}; known: {ROUTERS}")
        self.policy = policy
        self.perf = perf
        self.c_set = tuple(sorted(c_set))
        self.b_set = tuple(sorted(b_set))
        assert c0 in self.c_set, (c0, self.c_set)
        self.tick = tick
        self.resize_penalty = resize_penalty
        self.dispatch_margin = dispatch_margin
        self.prior_rps = prior_rps
        self.rate_window = rate_window
        self.router = router
        # only the edf-deadline router bisects the sorted deadline
        # mirror; the other routers skip its upkeep (an O(backlog)
        # insort per arrival that nothing would read)
        self._track_dls = router == "edf-deadline"
        # model ladder: per-rung latency tables + the resident
        # rung; ``self._lat`` is mutated IN PLACE on a swap because both
        # engines hold local aliases to it across dispatch loops
        self.ladder = ladder
        if ladder is not None:
            self.model = (m0 or getattr(policy, "model", None)
                          or ladder[0].name)
            ladder.rung(self.model)          # validate
            self._lat_by_m: Dict[str, dict] = {
                rung.name: {(c, b): float(rung.cost.latency(b, c))
                            for c in self.c_set for b in self.b_set}
                for rung in ladder}
            self._lat: Dict[tuple[int, int], float] = dict(
                self._lat_by_m[self.model])
            self.model_log: List[tuple[float, str, float]] = [
                (0.0, self.model, ladder.accuracy(self.model))]
        else:
            self.model = None
            self.model_log = []
            # precomputed latency table: identical floats to perf.latency
            self._lat = {(c, b): float(perf.latency(b, c))
                         for c in self.c_set for b in self.b_set}
        self._bucket_arr = build_bucket_array(self.b_set)
        self._bmax = self.b_set[-1]
        self._rid = itertools.count()
        self.b = 1
        self.replicas: List[FleetReplica] = []
        self.dead: List[FleetReplica] = []
        self.max_replicas = 0
        for _ in range(max(1, n0)):
            self._add_replica(c0, ready_at=0.0, now=0.0)
        self.core_samples: List[tuple[float, int]] = []
        self.bucket_log: List[tuple[float, int, int, int]] = []
        self.events_processed = 0

    # -- substrate hooks (overridden per engine) ---------------------------
    def _new_queue(self):
        raise NotImplementedError

    def _requeue(self, src: FleetReplica, now: float) -> None:
        """Re-route every queued item of ``src`` onto the survivors (EDF
        order, through the configured router)."""
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------
    def _bucket(self, b: int) -> int:
        return int(self._bucket_arr[b]) if b <= self._bmax else self._bmax

    def _cold_load(self, now: float):
        """Cold-start penalty hook for :func:`route_request`: a booting
        replica's remaining boot seconds expressed in queue-slot
        equivalents (requests a warm replica of the same shape would
        serve in that time), so routers only send work to a cold replica
        once every warm queue is at least that deep."""
        b = self._bucket(self.b)
        lat = self._lat

        def f(r: FleetReplica) -> float:
            w = r.ready_at - now
            if w <= 0.0:
                return 0.0
            return w * b / lat[(r.c, b)]

        return f

    @property
    def allocated_cores(self) -> int:
        return sum(r.c for r in self.replicas)

    def _add_replica(self, c: int, ready_at: float, now: float
                     ) -> FleetReplica:
        r = FleetReplica(next(self._rid), c, ready_at, now,
                         self._new_queue())
        self.replicas.append(r)
        self.max_replicas = max(self.max_replicas,
                                len(self.replicas))
        return r

    def _retire(self, r: FleetReplica, now: float) -> None:
        """Scale-down drain: stop admitting (the caller already removed
        ``r`` from the active list), re-route its queue, finish in-flight
        work, release cores at ``max(now, busy_until)``."""
        self._requeue(r, now)
        r.dead_at = max(now, r.busy_until)
        self.dead.append(r)

    def _rate(self, now: float) -> float:
        """Sliding-window λ — the shared ``core.monitor.array_window_rate``
        estimate, resolved through one helper by the single-replica fast
        path and both fleet engines so decisions cannot drift on the
        estimator."""
        if self._ai is None:
            # closed-world batch replay: the observed-arrival count is
            # derived from the sorted column at tick time (bit-identical
            # to the per-arrival counter, since arrivals at T precede
            # the tick at T) — no Python work per arrival
            lam, self._w0 = tick_window_rate(self._arr, self._w0, now,
                                             self.rate_window,
                                             self.prior_rps)
        else:
            lam, self._w0 = array_window_rate(self._arr, self._ai,
                                              self._w0, now,
                                              self.rate_window,
                                              self.prior_rps)
        return lam

    def _drive(self, now: float, lam: Optional[float] = None) -> None:
        """One adaptation step: global snapshot -> joint decide -> apply.

        ``lam`` overrides the λ source (the online session passes its
        cancel-aware estimate; the closed-world oracle loop uses the
        runner's own two-pointer window) — one copy of the drive rule,
        so the session and oracle paths cannot drift."""
        pol = self.policy
        if hasattr(pol, "due") and not pol.due(now):
            return
        if lam is None:
            lam = self._rate(now)
        reps = self.replicas
        iw = min(max(r.busy_until - now, 0.0) for r in reps)
        rem = np.sort(np.concatenate(
            [r.queue.remaining_array(now) for r in reps]))
        d = pol.decide_fleet(now, rem, lam, initial_wait=iw,
                             active_n=len(reps))
        self._apply(d, now)

    def _apply(self, d: Decision, now: float) -> None:
        """Apply a joint decision: retire extras (drain), swap the model
        if the decision carries a new rung, resize the survivors in
        place, then add cold-starting replicas.

        **Drain-before-swap**: a model swap never interrupts in-flight
        work — batches already dispatched keep their finish times (they
        were computed on the old rung's surface) and the weights-load
        penalty extends ``busy_until`` past them, so a replica serves
        its first new-model batch only after the old-model batch
        completed *and* the new weights loaded.  The penalty is the
        model-swap analogue of the resize penalty / horizontal cold
        start, and like them it only delays dispatch: core-second
        accounting is untouched (the replica's cores stay allocated
        either way — property-tested by the degradation tests).
        """
        c, self.b = resolve_decision(self.c_set, d)
        n = max(1, int(getattr(d, "n", 1)))
        reps = self.replicas
        if n < len(reps):
            for _ in range(min(len(reps) - n, len(reps) - 1)):
                self._retire(reps.pop(), now)       # youngest first
        swap_pen = 0.0
        m = getattr(d, "m", None)
        if self.ladder is not None and m is not None and m != self.model:
            swap_pen = float(self.ladder.swap_cost(m))
            self.model = m
            # in place: both engines alias self._lat across dispatches
            self._lat.clear()
            self._lat.update(self._lat_by_m[m])
            self.model_log.append((now, m, self.ladder.accuracy(m)))
        pen = self.resize_penalty
        for r in reps:
            r.account(now)
            if r.c != c:
                r.c = c
                if pen:
                    r.busy_until = max(r.busy_until, now) + pen
            if swap_pen:
                r.busy_until = max(r.busy_until, now) + swap_pen
        if n > len(reps):
            delay = getattr(d, "scale_up_delay", 0.0)
            for _ in range(n - len(reps)):
                self._add_replica(c, ready_at=now + delay, now=now)

    def _fleet_event(self, kind: str, args: tuple, now: float) -> None:
        """Apply one fleet disruption (see the module docstring)."""
        reps = self.replicas
        if kind == "kill":
            if len(reps) <= 1:
                return                 # never kill the last replica
            r = reps.pop(int(args[0]) % len(reps))
            self._retire(r, now)
        else:                          # restart
            r = reps.pop(int(args[0]) % len(reps))
            delay = float(args[1]) if len(args) > 1 else 5.0
            self._add_replica(r.c, ready_at=now + delay, now=now)
            self._retire(r, now)

    def _report(self, batch: RequestBatch, finish: np.ndarray,
                horizon: float) -> RunReport:
        """Aggregate through the shared ``serving.api.build_array_report``
        (same served/violation/percentile/core-second conventions as the
        single-replica fast path, by construction); ladder runs add the
        accuracy-weighted goodput axes from the resident-model
        timeline."""
        rep = build_array_report(self.policy, self.backend_name, batch,
                                 finish, horizon,
                                 self.replicas + self.dead,
                                 self.core_samples, self.bucket_log)
        return self._enrich_report(rep, finish, batch.deadline, horizon)

    def _enrich_report(self, rep: RunReport, finish: np.ndarray,
                       deadline: np.ndarray, horizon: float) -> RunReport:
        """Attach the degradation axes (accuracy-weighted goodput, swap
        count, resident-model timeline) on ladder runs — shared by the
        closed-world report above and the online ``FleetSession`` report,
        so the two cannot drift on the metric."""
        if self.ladder is None:
            return rep
        agp, macc = accuracy_weighted_goodput(finish, deadline,
                                              self.model_log, horizon)
        return replace(rep, accuracy_goodput=agp,
                       mean_served_accuracy=macc,
                       model_swaps=len(self.model_log) - 1,
                       model_timeline=list(self.model_log))


class FleetFastSimRunner(_FleetRunnerBase):
    """The fleet control loop on bare arrays — the ≥500k-request engine.

    Streamed arrivals / adaptation ticks / fleet events (three sorted
    cursors), an event heap holding only batch completions and per-
    replica wake-ups (deduplicated), per-replica ``FastEDFQueue``s of
    bare ``(deadline, index)`` pairs, and one dispatch pass per event
    mirroring ``FastSimRunner``'s slack-aware EDF rules replica by
    replica.  Event order at equal times: arrivals, then ticks, then
    fleet events, then dynamic events — exactly the order the exact
    gang loop's pre-heaped ``(t, seq)`` keys produce, which is one half
    of the decision-identity contract the fleet tests hold.
    """

    backend_name = "fleet-fast"

    def _new_queue(self) -> FastEDFQueue:
        return FastEDFQueue()

    def _requeue(self, src: FleetReplica, now: float) -> None:
        items = src.queue.drain()                           # EDF order
        src.dls.clear()
        cold = self._cold_load(now)
        for dl, idx in items:
            j = route_request(self.router, self.replicas, dl, now,
                              cold_load=cold)
            tgt = self.replicas[j]
            tgt.queue.push(dl, idx)
            if self._track_dls:
                insort(tgt.dls, dl)

    def session(self, fleet_events=()
                ) -> "repro_torch.serving.session.FleetSession":
        """Open the online session on this fleet (``submit`` /
        ``update_slo`` / ``cancel`` / ``step_until``; a tightened budget
        re-routes through the arrival router — see
        ``repro_torch.serving.session``).  ``fleet_events`` are the optional
        kill/restart disruptions."""
        from repro_torch.serving.session import FleetSession
        return FleetSession(self, fleet_events=fleet_events)

    def run(self, batch: RequestBatch, horizon: Optional[float] = None,
            events=()) -> RunReport:
        """Thin replay wrapper over :meth:`session`: submit the whole
        struct-of-arrays workload (plus optional fleet events), drain
        to the horizon, report.  With no mid-flight renegotiation the
        session replays the identical event stream the closed-world
        fleet loop did — the decision-identity contract
        the fleet tests hold against the pre-heaped
        :class:`FleetExactRunner` oracle."""
        sess = self.session(fleet_events=events)
        sess.submit_batch(batch)
        return sess.finish(horizon)


class FleetExactRunner(_FleetRunnerBase):
    """The exact fleet gang loop — the decision-identity oracle.

    Organized like ``serving.reference.ReferenceRunner``: every
    arrival, every adaptation tick and every fleet event is heap-pushed
    up front with a sequence number (so ties resolve arrivals → ticks →
    fleet events → dynamic events), requests are real ``Request``
    objects on per-replica ``EDFQueue``s, and each event triggers a full
    dispatch scan over the pool.  Slow and easy to audit — exactly what
    an oracle should be.  The fleet tests prove
    :class:`FleetFastSimRunner` produces identical ``(n, c, b)``
    decision streams, batch buckets and aggregates on the fleet
    scenarios.
    """

    backend_name = "fleet-exact"

    def _new_queue(self) -> EDFQueue:
        return EDFQueue()

    def _requeue(self, src: FleetReplica, now: float) -> None:
        items = src.queue.pop_batch(len(src.queue))         # EDF order
        src.dls.clear()
        cold = self._cold_load(now)
        for req in items:
            j = route_request(self.router, self.replicas, req.deadline,
                              now, cold_load=cold)
            tgt = self.replicas[j]
            tgt.queue.push(req)
            if self._track_dls:
                insort(tgt.dls, req.deadline)

    def run(self, batch: RequestBatch, horizon: Optional[float] = None,
            events=()) -> RunReport:
        """Materialize ``Request`` objects and run the pre-heaped gang
        loop over them; returns a :class:`RunReport` with the same
        conventions as the fast engine."""
        arr = np.ascontiguousarray(batch.arrival, np.float64)
        n = arr.size
        if n and np.any(np.diff(arr) < 0):
            raise ValueError("RequestBatch must be sorted by arrival")
        if horizon is None:
            horizon = float(arr[-1]) + 60.0 if n else 60.0
        reqs = batch.to_requests()
        pos = {r.id: i for i, r in enumerate(reqs)}
        finish = np.full(n, np.nan)
        self._arr = arr
        self._ai = None              # tick-granular λ (no cancels here)
        self._w0 = 0
        lat = self._lat
        bucket_arr = self._bucket_arr
        margin = self.dispatch_margin
        tick = self.tick
        track_dls = self._track_dls
        slack_wake: Dict[int, float] = {}
        busy_wake: Dict[int, float] = {}
        events_heap: list = []
        seq = itertools.count()
        push, pop = heapq.heappush, heapq.heappop
        for req in reqs:                         # arrivals first...
            push(events_heap, (req.arrival, next(seq), "arrival", req))
        t = 0.0
        while t <= horizon:                      # ...then the tick train
            push(events_heap, (t, next(seq), "tick", None))
            t += tick
        for (te, kind, args) in normalize_fleet_events(events):
            push(events_heap, (te, next(seq), "fleet", (kind, args)))
        n_events = 0

        while events_heap:
            t, _, kind, item = pop(events_heap)
            if t > horizon:
                break
            n_events += 1
            if kind == "arrival":
                j = route_request(self.router, self.replicas,
                                  item.deadline, t,
                                  cold_load=self._cold_load(t))
                tgt = self.replicas[j]
                tgt.queue.push(item)
                if track_dls:
                    insort(tgt.dls, item.deadline)
            elif kind == "tick":
                self._drive(t)
                self.core_samples.append((t, self.allocated_cores))
            elif kind == "fleet":
                ev_kind, ev_args = item
                self._fleet_event(ev_kind, ev_args, t)
            # else: "check" — fall through to the dispatch scan
            b_now = self.b
            for r in self.replicas:
                queue = r.queue
                if not len(queue):
                    continue
                if r.ready_at > t or r.busy_until > t:
                    wake_t = (r.ready_at if r.ready_at > r.busy_until
                              else r.busy_until)
                    if busy_wake.get(r.id) != wake_t:
                        busy_wake[r.id] = wake_t
                        push(events_heap, (wake_t, next(seq), "check",
                                           r.id))
                    continue
                while len(queue) and r.busy_until <= t:
                    if len(queue) < b_now:
                        head = queue.peek()
                        l_full = lat[(r.c, self._bucket(b_now))]
                        t_force = head.deadline - l_full - margin
                        if t < t_force:
                            tw = min(t_force, t + tick)
                            if slack_wake.get(r.id) != tw:
                                slack_wake[r.id] = tw
                                push(events_heap, (tw, next(seq), "check",
                                                   r.id))
                            break
                    gang = queue.pop_batch(b_now)
                    m = len(gang)
                    if track_dls:
                        del r.dls[:m]   # pop_batch took the m earliest
                    bucket = int(bucket_arr[m])
                    fin = t + lat[(r.c, bucket)]
                    r.busy_until = fin
                    self.bucket_log.append((t, r.c, bucket, m))
                    for req in gang:
                        req.start_proc = t
                        req.finish = fin
                        finish[pos[req.id]] = fin
                    push(events_heap, (fin, next(seq), "check", r.id))

        self.events_processed = n_events
        return self._report(batch, finish, horizon)
