"""Multi-tenant serving: one core pool, many per-tenant SLO solvers.

Copy of ``repro.serving.tenancy``, with the reference's float
expressions term for term (NumPy only, no device).  Sponge (and the
fleet layer above it) allocates cores to **one** model; a production
cluster serves a zoo of heterogeneous models with per-tenant SLO
distributions competing for one budget -- the horizontal/vertical
reconciliation problem of "A Tale of Two Scales" (Razavi et al. 2024)
taken across tenants.  This module is that layer:

* :class:`TenantSpec` -- one tenant: a cost model (fixed-work
  :class:`~repro_torch.core.perf_model.PerfModel` or a token
  :class:`~repro_torch.core.cost_model.TokenCostModel` via its
  fixed-work surface), its own workload (:class:`RequestBatch` with
  per-request dynamic SLOs), a rate prior, and the pool-facing knobs
  (``weight`` for fair-share, ``priority`` for preemption order).
* :class:`TenantPool` -- owns the fixed core ``budget`` and the
  per-tenant caps.  Every reallocation round it prices a core transfer
  by **marginal SLO value**: each tenant's
  :meth:`~repro_torch.core.solver.JointSolverTable.min_violations`
  frontier gives ``V(cap)`` (fewest predicted EDF violations achievable
  under the cap), and the pool compares the receiver's ``gain = V(cap) -
  V(cap + step)`` against the donor's ``loss = V(cap - step) - V(cap)``
  under a pluggable policy (``greedy-marginal`` / ``fair-share`` /
  ``priority``).  A proposed swap must persist ``swap_patience``
  consecutive rounds before it executes (the same hysteresis idea as
  the fleet scaler's ``down_patience``), and the losing tenant sheds
  cores through the fleet's drain-before-release machinery -- its next
  capped solve emits a smaller fleet, retiring replicas re-route their
  queues and finish in-flight work before the cores actually free.
* Two engines, one semantics: :class:`TenantFastRunner` interleaves
  every tenant's struct-of-arrays request stream in **one** event loop
  (per-tenant arrival cursors, one global tick train, one dynamic-event
  heap; each tenant keeps its own EDF substrate -- a
  :class:`~repro_torch.serving.fleet.FleetFastSimRunner` fleet under a
  capped :class:`~repro_torch.serving.fleet.FleetSpongeScaler`), and
  :class:`TenantExactRunner` is the pre-heaped oracle (every arrival
  and tick heap-pushed up front with ``(t, seq)`` keys, ``Request``
  objects, the :class:`~repro_torch.serving.fleet.FleetExactRunner`
  gang dispatch) the fast engine is held decision-identical to
  (``tests/test_torch_tenancy.py``, every ``mixed-zoo`` scenario x
  policy, and both against the reference's engines).

Tie order at equal event times: tenant arrivals (tenant index
ascending), then the pool tick (reallocate, then drive every tenant's
scaler in index order), then dynamic events -- the exact engine's
pre-heap sequence numbers produce the same order by construction.

Caps are a **planning** constraint, not an instantaneous one: a tenant
whose cap just dropped keeps its cores until the drain completes (the
hysteresis pin can hold ``n`` above the capped solve for
``down_patience`` ticks), so ``sum(caps) <= budget`` is the invariant
the pool maintains while allocated cores converge to it from above.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import insort
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import CostModel
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.solver import (DEFAULT_B, DEFAULT_C, DEFAULT_N,
                               JointSolverTable)
from repro_torch.serving.api import RunReport, build_array_report
from repro_torch.serving.fleet import (FleetExactRunner, FleetFastSimRunner,
                                 FleetSpongeScaler, route_request)
from repro_torch.serving.workload import RequestBatch

POOL_POLICIES = ("priority", "fair-share", "greedy-marginal")
INF = float("inf")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant of the shared pool.

    ``cost`` is anything the joint solver understands — a fixed-work
    :class:`~repro_torch.core.perf_model.PerfModel` or a
    :class:`~repro_torch.core.cost_model.TokenCostModel` (whose batch-latency
    surface prices a batch of mean-shaped autoregressive requests, so a
    chat tenant shares the pool with vision tenants at request
    granularity).  ``batch`` is the tenant's own workload;
    ``expected_rps`` seeds its λ window.  ``weight`` sets the
    fair-share target, ``priority`` the preemption order (lower =
    more important).  ``n0`` replicas deploy at t=0; the per-tenant
    ``(c_set, b_set, n_set)`` grids bound its joint solver.
    """
    name: str
    cost: Union[PerfModel, CostModel]
    batch: RequestBatch
    expected_rps: float
    weight: float = 1.0
    priority: int = 0
    n0: int = 2
    c_set: Sequence[int] = DEFAULT_C
    b_set: Sequence[int] = DEFAULT_B
    n_set: Sequence[int] = DEFAULT_N


class _PoolPolicyView:
    """Aggregate-report shim: the pool has no single decision stream
    (each tenant's scaler keeps its own), so the pool-level
    :class:`~repro_torch.serving.api.RunReport` carries only the policy name."""

    def __init__(self, name: str):
        self.name = name
        self.decisions = None


class TenantPool:
    """The fixed core budget and its division into per-tenant caps.

    Initial caps are the largest-remainder proportional split of
    ``budget`` by tenant ``weight`` (floored at ``min_cores``), unless
    ``initial_caps`` overrides them.  :meth:`reallocate` runs one
    swap round: compute every tenant's marginal profile
    (:meth:`marginal_profile`), let the policy propose at most one
    ``(donor, receiver, amount)`` transfer, and execute it only after
    the **same** donor/receiver pair has been proposed for
    ``swap_patience`` consecutive rounds (swap hysteresis — transient
    load blips don't churn cores).  ``sum(caps) <= budget`` always;
    ``cap_log`` and ``swaps`` record the trajectory for tests and the
    benchmark.
    """

    def __init__(self, specs: Sequence[TenantSpec], *, budget: int = 128,
                 policy: str = "greedy-marginal", swap_step: int = 16,
                 swap_patience: int = 2, min_cores: int = 4,
                 price_window: float = 1.0, min_gain: float = 2.0,
                 initial_caps: Optional[Sequence[int]] = None):
        if policy not in POOL_POLICIES:
            raise KeyError(f"unknown pool policy {policy!r}; "
                           f"known: {POOL_POLICIES}")
        self.specs = list(specs)
        k = len(self.specs)
        if not k:
            raise ValueError("TenantPool needs at least one tenant")
        if budget < k * min_cores:
            raise ValueError(f"budget {budget} cannot floor {k} tenants "
                             f"at {min_cores} cores each")
        self.budget = int(budget)
        self.policy = policy
        self.swap_step = int(swap_step)
        self.swap_patience = int(swap_patience)
        self.min_cores = int(min_cores)
        self.price_window = float(price_window)
        self.min_gain = float(min_gain)
        self._targets = self._proportional()
        if initial_caps is not None:
            caps = [int(c) for c in initial_caps]
            if len(caps) != k or any(c < min_cores for c in caps) \
                    or sum(caps) > budget:
                raise ValueError(f"bad initial_caps {caps!r} for "
                                 f"budget {budget}")
            self.caps = caps
        else:
            self.caps = list(self._targets)
        self._tables: List[Optional[JointSolverTable]] = [None] * k
        self.cap_log: List[tuple] = []
        self.swaps: List[tuple] = []
        self._streak = 0
        self._streak_key: Optional[tuple] = None

    # -- allocation arithmetic ---------------------------------------------
    def _proportional(self) -> List[int]:
        """Largest-remainder split of the budget by tenant weight,
        floored at ``min_cores`` (deterministic at every tie)."""
        w = np.asarray([max(float(s.weight), 0.0) for s in self.specs])
        if w.sum() <= 0:
            w = np.ones_like(w)
        raw = self.budget * w / w.sum()
        caps = np.floor(raw).astype(int)
        rem_order = sorted(range(len(caps)),
                           key=lambda i: (-(raw[i] - caps[i]), i))
        for i in rem_order[:self.budget - int(caps.sum())]:
            caps[i] += 1
        caps = np.maximum(caps, self.min_cores)
        while caps.sum() > self.budget:          # flooring overshot
            i = int(np.argmax(caps))             # ties -> lowest index
            assert caps[i] > self.min_cores
            caps[i] -= 1
        return [int(c) for c in caps]

    def bind_table(self, k: int, table: JointSolverTable) -> None:
        """Attach tenant ``k``'s solver table (its feasibility frontier
        is what :meth:`marginal_profile` differentiates)."""
        self._tables[k] = table

    # -- marginal SLO value ------------------------------------------------
    def _value(self, table: JointSolverTable, rem: np.ndarray, lam: float,
               iw: float, cap: int) -> float:
        """``V(cap)``: predicted violations for tenant state
        ``(rem, lam, iw)`` under a core cap.  Two terms: the backlog
        term (:meth:`JointSolverTable.min_violations` — queued requests
        no capped config can save) plus the **overflow** term
        ``max(0, λ - max_rate(cap)) * price_window`` — arrivals the
        capped frontier cannot absorb over the next pricing window.
        The overflow term is what keeps the marginal signal alive
        through a sustained overload: once a backlog is doomed, extra
        cores stop moving the backlog term, but they keep raising the
        sustainable-rate ceiling until λ fits.
        """
        over = max(0.0, lam - table.max_rate(cap)) * self.price_window
        if rem.size == 0:
            return over
        return table.min_violations(rem, lam, initial_wait=iw,
                                    max_cores=cap) + over

    def marginal_profile(self, k: int, snapshot) -> dict:
        """Price tenant ``k``'s next core transfer from a queue snapshot.

        ``snapshot`` is ``(remaining, lam, initial_wait)`` — the same
        headroom-adjusted budgets the tenant's scaler would solve with.
        Returns ``{"v", "gain", "loss"}``: ``v = V(cap)`` predicted
        violations at the current cap (backlog + λ-overflow, see
        :meth:`_value`), ``gain = V(cap) - V(cap+step)`` the violations
        one step of cores would remove, and ``loss = V(cap-step) -
        V(cap)`` (clamped at 0 — the violation grid is a prediction and
        may wobble non-monotonically) the violations donating a step
        would cost.  ``loss`` is ``None`` when the donation would
        breach ``min_cores`` — the tenant cannot donate.  A tenant at
        ``V = 0`` has nothing to gain and skips the ``cap+step`` solve.
        """
        rem, lam, iw = snapshot
        cap = self.caps[k]
        step = self.swap_step
        can_donate = cap - step >= self.min_cores
        rem = np.asarray(rem, np.float64)
        table = self._tables[k]
        assert table is not None, f"tenant {k} has no bound solver table"
        v = self._value(table, rem, lam, iw, cap)
        gain = 0.0
        if v > 0:
            gain = max(0.0, v - self._value(table, rem, lam, iw,
                                            cap + step))
        loss = None
        if can_donate:
            loss = max(0.0, self._value(table, rem, lam, iw,
                                        cap - step) - v)
        return {"v": v, "gain": gain, "loss": loss}

    # -- the swap round ----------------------------------------------------
    def reallocate(self, now: float, snapshots: Sequence) -> List[dict]:
        """One swap round at time ``now`` over per-tenant snapshots.

        Computes every tenant's marginal profile, asks the policy for a
        proposal, applies swap hysteresis, executes at most one
        transfer, and logs ``caps`` — returns the profiles (the engines
        ignore them; tests and the benchmark read the logs).
        """
        profiles = [self.marginal_profile(k, s)
                    for k, s in enumerate(snapshots)]
        prop = self._propose(profiles)
        if prop is None:
            self._streak = 0
            self._streak_key = None
        else:
            key = prop[:2]
            self._streak = self._streak + 1 if key == self._streak_key \
                else 1
            self._streak_key = key
            if self._streak >= self.swap_patience:
                donor, recv, amt = prop
                self.caps[donor] -= amt
                self.caps[recv] += amt
                self.swaps.append((now, donor, recv, amt))
                self._streak = 0
                self._streak_key = None
        assert sum(self.caps) <= self.budget, (self.caps, self.budget)
        self.cap_log.append((now, tuple(self.caps)))
        return profiles

    def _propose(self, profiles: List[dict]) -> Optional[tuple]:
        """Policy dispatch: at most one ``(donor, receiver, amount)``."""
        if self.policy == "greedy-marginal":
            return self._propose_greedy(profiles)
        if self.policy == "fair-share":
            return self._propose_fair()
        return self._propose_priority(profiles)

    def _propose_greedy(self, profiles: List[dict]) -> Optional[tuple]:
        """Highest marginal gain receives; the donor losing the least
        gives (ties: deepest cap, then index); swap iff gain > loss and
        gain clears ``min_gain`` (prediction-noise gains of a request
        or two must not churn cores)."""
        recv, best_gain = None, 0.0
        for k, p in enumerate(profiles):
            if p["gain"] > best_gain:
                recv, best_gain = k, p["gain"]
        if recv is None or best_gain < self.min_gain:
            return None
        donor, best_key = None, None
        for k, p in enumerate(profiles):
            if k == recv or p["loss"] is None:
                continue
            key = (p["loss"], -self.caps[k], k)
            if best_key is None or key < best_key:
                donor, best_key = k, key
        if donor is None or best_gain <= profiles[donor]["loss"]:
            return None
        return (donor, recv, self.swap_step)

    def _propose_fair(self) -> Optional[tuple]:
        """Steer caps to the weight-proportional targets: the deepest
        deficit receives from the deepest surplus, transfer sized so the
        pair never overshoots — proposals cease exactly at the target
        (convergence is property-tested)."""
        deficit = [self._targets[k] - self.caps[k]
                   for k in range(len(self.caps))]
        recv = max(range(len(deficit)), key=lambda k: (deficit[k], -k))
        donor = min(range(len(deficit)), key=lambda k: (deficit[k], k))
        if deficit[recv] <= 0 or deficit[donor] >= 0:
            return None
        amt = min(self.swap_step, deficit[recv], -deficit[donor])
        return (donor, recv, amt)

    def _propose_priority(self, profiles: List[dict]) -> Optional[tuple]:
        """Strict preemption: the most important violating tenant
        (lowest ``priority`` number) takes a step from the least
        important tenant that can still donate — donor loss is ignored
        by design, so a low-priority tenant under overload is starved
        down to ``min_cores`` and simply reports its violations (the
        floor is what makes starvation livelock-free)."""
        specs = self.specs
        order = sorted(range(len(specs)),
                       key=lambda k: (specs[k].priority, k))
        recv = next((k for k in order
                     if profiles[k]["v"] > 0
                     and profiles[k]["gain"] >= self.min_gain),
                    None)
        if recv is None:
            return None
        donors = [k for k, p in enumerate(profiles)
                  if p["loss"] is not None
                  and specs[k].priority > specs[recv].priority]
        if not donors:
            return None
        donor = min(donors, key=lambda k: (-specs[k].priority,
                                           -self.caps[k], k))
        return (donor, recv, self.swap_step)


# --------------------------------------------------------------------------
# the two multi-tenant engines
# --------------------------------------------------------------------------
class _TenantRunnerBase:
    """Config + semantics shared verbatim by both tenant engines.

    Each tenant gets a private fleet substrate (an instance of the
    engine-matched fleet runner class, never driven through its own
    ``run``) under a capped :class:`FleetSpongeScaler`; the tenant
    loop owns the event ordering, the pool tick (reallocate + drive
    every scaler) and reporting.  Only the event-loop organization
    differs per subclass — the exact pre-heaped loop is the oracle the
    interleaved fast loop is held to.
    """

    backend_name = "tenant-pool"
    _sub_cls: type = None

    def __init__(self, specs: Sequence[TenantSpec], *, budget: int = 128,
                 policy: str = "greedy-marginal",
                 realloc_interval: float = 1.0, swap_step: int = 16,
                 swap_patience: int = 2, min_cores: int = 4,
                 min_gain: float = 2.0,
                 tick: float = 0.5, router: str = "least-loaded",
                 budget_quantum: float = 0.0, lam_quantum: float = 0.0,
                 down_patience: int = 5, marginal_cap: int = 2048,
                 initial_caps: Optional[Sequence[int]] = None):
        self.specs = list(specs)
        self.pool = TenantPool(self.specs, budget=budget, policy=policy,
                               swap_step=swap_step,
                               swap_patience=swap_patience,
                               min_cores=min_cores,
                               price_window=realloc_interval,
                               min_gain=min_gain,
                               initial_caps=initial_caps)
        self.tick = float(tick)
        self.realloc_interval = float(realloc_interval)
        self.marginal_cap = int(marginal_cap)
        self._next_realloc = 0.0
        self.subs = []
        for k, (spec, cap) in enumerate(zip(self.specs, self.pool.caps)):
            scaler = FleetSpongeScaler(
                spec.cost, name=f"sponge-tenant-{spec.name}",
                c_set=tuple(spec.c_set), b_set=tuple(spec.b_set),
                n_set=tuple(spec.n_set), adaptation_interval=self.tick,
                budget_quantum=budget_quantum, lam_quantum=lam_quantum,
                down_patience=down_patience, core_cap=cap)
            n0 = max(1, int(spec.n0))
            # deploy the largest core count whose n0-replica fleet fits
            # the tenant's initial cap
            fits = [c for c in sorted(spec.c_set) if n0 * c <= cap]
            c0 = max(fits) if fits else min(spec.c_set)
            sub = self._sub_cls(scaler, spec.cost, spec.c_set, spec.b_set,
                                n0=n0, c0=c0, tick=self.tick,
                                prior_rps=spec.expected_rps, router=router)
            self.pool.bind_table(k, scaler.memo.table)
            self.subs.append(sub)
        self.core_timeline: List[tuple] = []
        self.events_processed = 0
        self.tenant_reports: List[RunReport] = []

    # -- pool control ------------------------------------------------------
    def _snapshot(self, sub, t: float):
        """Tenant queue snapshot in the scaler's own solve coordinates
        (headroom-adjusted budgets, λ with provisioning margin), so the
        marginal prices and the capped solves read the same frontier.
        ``marginal_cap`` bounds the grid work per round; the λ window
        read is idempotent at a fixed ``(now, arrivals)`` so the drive
        that follows sees the identical estimate."""
        sc = sub.policy
        reps = sub.replicas
        iw = min(max(r.busy_until - t, 0.0) for r in reps)
        rem = np.sort(np.concatenate(
            [r.queue.remaining_array(t) for r in reps]))
        rem = np.maximum(rem - sc.headroom, 0.0)[:self.marginal_cap]
        lam = sub._rate(t) * sc.lam_headroom
        return (rem, lam, iw)

    def _pool_tick(self, t: float) -> None:
        """The tick handler both engines share: reallocate when due
        (push the new caps into every scaler), then drive each tenant's
        scaler in index order and sample the core timelines."""
        if t + 1e-12 >= self._next_realloc:
            self._next_realloc = t + self.realloc_interval
            snaps = [self._snapshot(sub, t) for sub in self.subs]
            self.pool.reallocate(t, snaps)
            for sub, cap in zip(self.subs, self.pool.caps):
                sub.policy.core_cap = cap
        total = 0
        for sub in self.subs:
            sub._drive(t)
            sub.core_samples.append((t, sub.allocated_cores))
            total += sub.allocated_cores
        self.core_timeline.append((t, total))

    # -- reporting ---------------------------------------------------------
    def _default_horizon(self) -> float:
        last = max((float(s.batch.arrival[-1]) for s in self.specs
                    if len(s.batch)), default=0.0)
        return last + 60.0

    def _finalize(self, finishes: List[np.ndarray],
                  horizon: float) -> RunReport:
        """Per-tenant reports through each substrate's own
        ``_report`` (the shared fleet aggregation), then the pool-level
        aggregate over the concatenated columns, every replica of every
        tenant, and the pool core timeline."""
        self.tenant_reports = [
            sub._report(spec.batch, fin, horizon)
            for spec, sub, fin in zip(self.specs, self.subs, finishes)]
        batches = [s.batch for s in self.specs]
        merged = RequestBatch(
            send=np.concatenate([b.send for b in batches]),
            arrival=np.concatenate([b.arrival for b in batches]),
            comm_latency=np.concatenate([b.comm_latency for b in batches]),
            slo=np.concatenate([b.slo for b in batches]),
            deadline=np.concatenate([b.deadline for b in batches]),
            size_kb=np.concatenate([b.size_kb for b in batches]))
        slots = [r for sub in self.subs for r in sub.replicas + sub.dead]
        buckets = sorted(itertools.chain.from_iterable(
            sub.bucket_log for sub in self.subs))
        view = _PoolPolicyView(f"tenant-pool-{self.pool.policy}")
        return build_array_report(view, self.backend_name, merged,
                                  np.concatenate(finishes), horizon,
                                  slots, self.core_timeline, buckets)


class TenantFastRunner(_TenantRunnerBase):
    """The interleaved struct-of-arrays engine — the ≥200k-request path.

    One event loop over per-tenant arrival cursors (ties resolve to the
    lowest tenant index), one global tick train, and one dynamic-event
    heap keyed ``(t, seq, tenant, replica)`` with per-(tenant, replica)
    deduplicated wake-ups; each event is followed by the fleet fast
    path's slack-aware EDF dispatch scan over every tenant's replicas
    in index order.  Decision-identical to :class:`TenantExactRunner`
    (``tests/test_torch_tenancy.py``).
    """

    backend_name = "tenant-fast"
    _sub_cls = FleetFastSimRunner

    def run(self, horizon: Optional[float] = None) -> RunReport:
        """Drain every tenant's workload to the horizon; returns the
        pool-level aggregate (per-tenant reports on
        ``self.tenant_reports``)."""
        subs = self.subs
        K = len(subs)
        arrs = [np.ascontiguousarray(s.batch.arrival, np.float64)
                for s in self.specs]
        dls = [np.ascontiguousarray(s.batch.deadline, np.float64)
               for s in self.specs]
        finishes = [np.full(a.size, np.nan) for a in arrs]
        for sub, arr in zip(subs, arrs):
            # tick-granular λ: the sorted arrival column replaces the
            # per-arrival counter (closed world, no cancels)
            sub._arr, sub._ai, sub._w0 = arr, None, 0
        if horizon is None:
            horizon = self._default_horizon()
        ptrs = [0] * K
        next_tick = 0.0
        events: list = []
        seq = itertools.count()
        busy_wake: Dict[tuple, float] = {}
        slack_wake: Dict[tuple, float] = {}
        tick = self.tick
        pop, push = heapq.heappop, heapq.heappush
        n_events = 0
        while True:
            ta, ka = INF, -1
            for k in range(K):
                p = ptrs[k]
                if p < arrs[k].size and arrs[k][p] < ta:
                    ta, ka = arrs[k][p], k
            tt = next_tick
            td = events[0][0] if events else INF
            if ta <= tt and ta <= td:
                et, kind = ta, 0
            elif tt <= td:
                et, kind = tt, 1
            else:
                et, kind = td, 2
            if et == INF or et > horizon:
                break
            n_events += 1
            if kind == 0:                        # arrival: route + enqueue
                sub = subs[ka]
                h = ptrs[ka]
                ptrs[ka] += 1
                d = dls[ka][h]
                j = route_request(sub.router, sub.replicas, d, et,
                                  cold_load=sub._cold_load(et))
                tgt = sub.replicas[j]
                tgt.queue.push(d, h)
                if sub._track_dls:
                    insort(tgt.dls, d)
            elif kind == 1:                      # pool tick
                next_tick += tick
                self._pool_tick(et)
            else:                                # completion / wake-up
                pop(events)
            self._dispatch(et, finishes, events, seq, busy_wake,
                           slack_wake)
        self.events_processed = n_events
        return self._finalize(finishes, horizon)

    # spongelint: inline-of repro_torch.serving.session.FleetSession._dispatch pin=df97912017f2
    def _dispatch(self, t: float, finishes, events, seq, busy_wake,
                  slack_wake) -> None:
        """Per-replica slack-aware EDF dispatch (the fleet fast-path
        rules, verbatim) over every tenant in index order."""
        tick = self.tick
        push = heapq.heappush
        for k, sub in enumerate(self.subs):
            b_now = sub.b
            lat = sub._lat
            bucket_arr = sub._bucket_arr
            margin = sub.dispatch_margin
            track_dls = sub._track_dls
            fin_arr = finishes[k]
            for rep in sub.replicas:
                q = rep.queue._heap
                if not q:
                    continue
                key = (k, rep.id)
                if rep.ready_at > t or rep.busy_until > t:
                    wake_t = (rep.ready_at
                              if rep.ready_at > rep.busy_until
                              else rep.busy_until)
                    if busy_wake.get(key) != wake_t:
                        busy_wake[key] = wake_t
                        push(events, (wake_t, next(seq), k, rep.id))
                    continue
                live = rep.queue._live
                while q and rep.busy_until <= t:
                    if len(live) < b_now:
                        head_dl = q[0][0]
                        l_full = lat[(rep.c, sub._bucket(b_now))]
                        t_force = head_dl - l_full - margin
                        if t < t_force:
                            tw = min(t_force, t + tick)
                            if slack_wake.get(key) != tw:
                                slack_wake[key] = tw
                                push(events, (tw, next(seq), k, rep.id))
                            break
                    idxs = rep.queue.pop_batch(b_now)
                    m = len(idxs)
                    if track_dls:
                        del rep.dls[:m]   # pop_batch took the m earliest
                    bucket = int(bucket_arr[m])
                    fin = t + lat[(rep.c, bucket)]
                    rep.busy_until = fin
                    sub.bucket_log.append((t, rep.c, bucket, m))
                    for i in idxs:
                        fin_arr[i] = fin
                    push(events, (fin, next(seq), k, rep.id))


class TenantExactRunner(_TenantRunnerBase):
    """The pre-heaped multi-tenant oracle.

    Organized like :class:`~repro_torch.serving.fleet.FleetExactRunner`:
    every tenant's arrivals (tenant-major, so equal-time ties resolve
    to the lowest tenant index) and the tick train are heap-pushed up
    front with sequence numbers, requests are real ``Request`` objects
    on per-replica object queues, and each event triggers the full
    gang dispatch scan over every tenant's pool.  Slow and auditable —
    the decision-identity oracle ``tests/test_torch_tenancy.py`` holds
    :class:`TenantFastRunner` to.
    """

    backend_name = "tenant-exact"
    _sub_cls = FleetExactRunner

    def run(self, horizon: Optional[float] = None) -> RunReport:
        """Materialize every tenant's ``Request`` objects and run the
        pre-heaped gang loop; same reporting as the fast engine."""
        subs = self.subs
        arrs = [np.ascontiguousarray(s.batch.arrival, np.float64)
                for s in self.specs]
        finishes = [np.full(a.size, np.nan) for a in arrs]
        for sub, arr in zip(subs, arrs):
            sub._arr, sub._ai, sub._w0 = arr, None, 0
        if horizon is None:
            horizon = self._default_horizon()
        reqs = [s.batch.to_requests() for s in self.specs]
        pos = [{r.id: i for i, r in enumerate(rs)} for rs in reqs]
        events_heap: list = []
        seq = itertools.count()
        push, pop = heapq.heappush, heapq.heappop
        for k, rs in enumerate(reqs):            # arrivals first...
            for req in rs:
                push(events_heap,
                     (req.arrival, next(seq), 0, (k, req)))
        t = 0.0
        while t <= horizon:                      # ...then the tick train
            push(events_heap, (t, next(seq), 1, None))
            t += self.tick
        busy_wake: Dict[tuple, float] = {}
        slack_wake: Dict[tuple, float] = {}
        n_events = 0
        while events_heap:
            t, _, kind, item = pop(events_heap)
            if t > horizon:
                break
            n_events += 1
            if kind == 0:                        # arrival
                k, req = item
                sub = subs[k]
                j = route_request(sub.router, sub.replicas, req.deadline,
                                  t, cold_load=sub._cold_load(t))
                tgt = sub.replicas[j]
                tgt.queue.push(req)
                if sub._track_dls:
                    insort(tgt.dls, req.deadline)
            elif kind == 1:                      # pool tick
                self._pool_tick(t)
            # else kind == 2: "check" — fall through to the dispatch scan
            for k, sub in enumerate(subs):
                b_now = sub.b
                lat = sub._lat
                bucket_arr = sub._bucket_arr
                margin = sub.dispatch_margin
                track_dls = sub._track_dls
                fin_arr = finishes[k]
                pos_k = pos[k]
                for rep in sub.replicas:
                    queue = rep.queue
                    if not len(queue):
                        continue
                    key = (k, rep.id)
                    if rep.ready_at > t or rep.busy_until > t:
                        wake_t = (rep.ready_at
                                  if rep.ready_at > rep.busy_until
                                  else rep.busy_until)
                        if busy_wake.get(key) != wake_t:
                            busy_wake[key] = wake_t
                            push(events_heap, (wake_t, next(seq), 2, key))
                        continue
                    while len(queue) and rep.busy_until <= t:
                        if len(queue) < b_now:
                            head = queue.peek()
                            l_full = lat[(rep.c, sub._bucket(b_now))]
                            t_force = head.deadline - l_full - margin
                            if t < t_force:
                                tw = min(t_force, t + self.tick)
                                if slack_wake.get(key) != tw:
                                    slack_wake[key] = tw
                                    push(events_heap,
                                         (tw, next(seq), 2, key))
                                break
                        gang = queue.pop_batch(b_now)
                        m = len(gang)
                        if track_dls:
                            del rep.dls[:m]
                        bucket = int(bucket_arr[m])
                        fin = t + lat[(rep.c, bucket)]
                        rep.busy_until = fin
                        sub.bucket_log.append((t, rep.c, bucket, m))
                        for req in gang:
                            req.start_proc = t
                            req.finish = fin
                            fin_arr[pos_k[req.id]] = fin
                        push(events_heap, (fin, next(seq), 2, key))
        self.events_processed = n_events
        return self._finalize(finishes, horizon)
