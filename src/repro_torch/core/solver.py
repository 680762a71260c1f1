"""The Sponge optimizer: Integer Program (paper Eq. 3) + Algorithm 1.

    minimize   c + delta_pen * b
    s.t.       l(b,c) + q_r(b,c) + cl_max <= SLO   for every request r
               h(b,c) >= lambda
               b, c in Z+

Copy of ``repro.core.solver``: the fixed-work solvers
(``solve_bruteforce``, the paper's Algorithm 1 with the reference's
``initial_wait`` term and damage-minimizing fallback; ``solve_pruned``;
``SolverTable`` behind a ``MemoizedSolver``), the joint fleet solvers
over ``(n, c, b)`` (``solve_joint_bruteforce``, ``JointSolverTable``
behind a ``JointMemoizedSolver``), the model-ladder solvers over
``(m, n, c, b)`` (``solve_multimodel_bruteforce``,
``MultiModelSolverTable`` behind a ``MultiModelMemoizedSolver``) and
the token solvers (``solve_token_bruteforce``, ``TokenSolverTable``
behind a ``TokenMemoizedSolver``), with the quantize-and-cache shell
they share.  The reference's ``TPU_C`` / ``TPU_B`` grids (powers of
two for a TPU submesh) are left out.
Algorithm 1 iterates c ascending then b ascending and returns the first
feasible (c, b): the lexicographic IP optimum.  The float expressions
and their summation order are the reference's term for term, so both
packages make the same decisions.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import CostModel, TokenCostModel
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.slo import Decision

DEFAULT_C = tuple(range(1, 17))
DEFAULT_B = tuple(range(1, 17))
# feasible replica counts for the joint (fleet) solver
DEFAULT_N = tuple(range(1, 17))


def _predicted_violations(rem: Sequence[float], l: float, b: int,
                          initial_wait: float) -> int:
    """Requests whose batch completes after their remaining budget."""
    n = len(rem)
    v = 0
    for idx in range(n):
        finish = initial_wait + (idx // b + 1) * l
        if finish > rem[idx]:
            v += 1
    return v


def solve_bruteforce(remaining_slos: Sequence[float], lam: float,
                     perf: PerfModel,
                     c_set: Sequence[int] = DEFAULT_C,
                     b_set: Sequence[int] = DEFAULT_B,
                     delta_pen: float = 1e-3,
                     initial_wait: float = 0.0) -> Decision:
    """Faithful Algorithm 1 (+ the fallback described in the module doc).

    remaining_slos: per queued request, the remaining budget SLO - cl_r
    (equivalently deadline - now); the EDF queue hands them over sorted
    ascending.  The binding budget of batch i in EDF order is that of its
    first request, rem[i*b].
    """
    t0 = time.perf_counter()
    rem = sorted(float(x) for x in remaining_slos)
    n = len(rem)
    iters = 0
    best_fallback = None  # (violations, c, b)
    for c in sorted(c_set):
        for b in sorted(b_set):
            iters += 1
            l = float(perf.latency(b, c))
            if lam > 0 and perf.throughput(b, c) < lam:
                continue
            ok = True
            q_r = initial_wait
            for i in range(0, max(n, 1), b):
                budget = rem[i] if n else float("inf")
                if l + q_r > budget:
                    ok = False
                    break
                q_r += l
                if n == 0:
                    break
            if ok:
                return Decision(c=c, b=b, feasible=True, solver_iters=iters,
                                solver_time=time.perf_counter() - t0)
            v = _predicted_violations(rem, l, b, initial_wait)
            # crisis ordering: fewest predicted violations, then fastest
            # drain (max throughput) — arrivals keep coming during a fade
            key = (v, -float(perf.throughput(b, c)))
            if best_fallback is None or key < best_fallback[0]:
                best_fallback = (key, c, b)
    if best_fallback is None:  # nothing sustains lam: max capacity config
        c = max(c_set)
        b = max(b_set, key=lambda bb: perf.throughput(bb, c))
        best_fallback = ((n, 0.0), c, b)
    _, c, b = best_fallback
    return Decision(c=c, b=b, feasible=False, solver_iters=iters,
                    solver_time=time.perf_counter() - t0)


def solve_pruned(remaining_slos: Sequence[float], lam: float,
                 perf: PerfModel,
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 delta_pen: float = 1e-3,
                 initial_wait: float = 0.0) -> Decision:
    """Vectorized exact solver (same constraint set, explicit argmin)."""
    t0 = time.perf_counter()
    rem = np.sort(np.asarray(list(remaining_slos), np.float64))
    n = len(rem)
    cs = np.asarray(sorted(c_set))
    bs = np.asarray(sorted(b_set))
    bb, cc = np.meshgrid(bs, cs, indexing="ij")       # (B, C)
    lat = perf.latency(bb, cc)
    thr = bb / np.maximum(lat, 1e-12)
    sustain = thr >= (lam if lam > 0 else 0.0)
    feas = sustain.copy()
    viol = np.zeros_like(lat, dtype=np.int64)
    if n:
        idx = np.arange(n)
        for j, b in enumerate(bs):
            batch_mult = idx // int(b) + 1                # (n,)
            finish = initial_wait + batch_mult[None, :] * lat[j][:, None]
            over = finish > rem[None, :] + 1e-12
            viol[j] = over.sum(axis=1)
            feas[j] &= ~over.any(axis=1)
    cost = cc + delta_pen * bb
    cost = np.where(feas, cost, np.inf)
    solver_time = time.perf_counter() - t0
    if np.isfinite(cost).any():
        j, i = np.unravel_index(np.argmin(cost), cost.shape)
        return Decision(c=int(cs[i]), b=int(bs[j]), feasible=True,
                        solver_iters=cost.size, solver_time=solver_time)
    # damage-minimizing fallback among sustainable configs (or all),
    # tie-broken by max throughput (fastest drain during the fade)
    pool = np.where(sustain, viol.astype(np.float64), viol.max() + 1e6 + cc)
    pool = pool - 1e-9 * thr
    j, i = np.unravel_index(np.argmin(pool), pool.shape)
    return Decision(c=int(cs[i]), b=int(bs[j]), feasible=False,
                    solver_iters=cost.size, solver_time=solver_time)


class SolverTable:
    """Precomputed numpy feasibility grids over the ``(c, b)`` space.

    Everything that depends only on (perf, c_set, b_set) — the latency
    grid l(b, c), the throughput grid h(b, c), and the flattened
    Algorithm-1 iteration order (c ascending, then b ascending) — is
    computed once here.  ``solve`` then answers each query with O(|C||B|)
    vectorized comparisons plus an O(n/b) reduction per batch size over
    the EDF batch heads; there is no per-config Python loop.

    The constraint set is exactly Algorithm 1's: batch i (0-indexed, EDF
    order) finishes at ``initial_wait + (i+1)·l(b, c)`` and must meet the
    budget of its head request ``rem[i·b]``; configs with
    ``h(b, c) < λ`` are discarded; the first feasible entry in (c, b)
    lexicographic order is the IP optimum.  The infeasible fallback
    replicates ``solve_bruteforce``: among sustainable configs, fewest
    predicted violations, ties broken by fastest drain.
    """

    def __init__(self, perf: Union[PerfModel, CostModel],
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B):
        self.perf = perf        # PerfModel or any CostModel (same surface)
        self.cs = np.asarray(sorted(c_set), np.int64)
        self.bs = np.asarray(sorted(b_set), np.int64)
        cc, bb = np.meshgrid(self.cs, self.bs, indexing="ij")   # (C, B)
        self.lat = np.asarray(perf.latency(bb, cc), np.float64)
        self.thr = bb / np.maximum(self.lat, 1e-12)
        self.c_flat = cc.ravel()
        self.b_flat = bb.ravel()
        self.size = self.lat.size

    def solve(self, remaining_slos, lam: float,
              initial_wait: float = 0.0) -> Decision:
        t0 = time.perf_counter()
        rem = np.sort(np.asarray(remaining_slos, np.float64).ravel())
        n = rem.size
        C, B = self.lat.shape
        feas = np.ones((C, B), bool)
        if n:
            for j in range(B):
                b = int(self.bs[j])
                heads = rem[::b]
                k = np.arange(1, heads.size + 1, dtype=np.float64)
                finish = initial_wait + self.lat[:, j, None] * k
                feas[:, j] = (finish <= heads).all(axis=1)
        sustain = (self.thr >= lam) if lam > 0 else np.ones((C, B), bool)
        ok = (feas & sustain).ravel()
        hit = np.flatnonzero(ok)
        if hit.size:
            i = int(hit[0])
            return Decision(c=int(self.c_flat[i]), b=int(self.b_flat[i]),
                            feasible=True, solver_iters=self.size,
                            solver_time=time.perf_counter() - t0)
        # fallback: among sustainable configs, fewest predicted violations,
        # then max throughput, then first in (c, b) order — bruteforce's
        # crisis ordering
        sus_flat = sustain.ravel()
        if sus_flat.any():
            viol = np.zeros((C, B), np.int64)
            if n:
                idx = np.arange(n, dtype=np.int64)
                for j in range(B):
                    b = int(self.bs[j])
                    mult = (idx // b + 1).astype(np.float64)
                    finish = initial_wait + self.lat[:, j, None] * mult
                    viol[:, j] = (finish > rem).sum(axis=1)
            key1 = np.where(sus_flat, viol.ravel().astype(np.float64),
                            np.inf)
            cand = np.flatnonzero(key1 == key1.min())
            thr_c = self.thr.ravel()[cand]
            i = int(cand[np.flatnonzero(thr_c == thr_c.max())[0]])
            c, b = int(self.c_flat[i]), int(self.b_flat[i])
        else:  # nothing sustains lam: max capacity config
            c = int(self.cs[-1])
            j = int(np.argmax(self.thr[-1]))
            b = int(self.bs[j])
        return Decision(c=c, b=b, feasible=False, solver_iters=self.size,
                        solver_time=time.perf_counter() - t0)


class _QuantizedDecisionCache:
    """The conservative quantize-and-cache shell shared by every
    memoized solver (fixed-work, token, joint fleet, model ladder).

    The bucketing rule is correctness-critical and lives HERE once: all
    load-like inputs round *against* the caller — remaining budgets are
    **floored** to ``budget_quantum`` (a cached decision never assumes
    more slack than the live queue has), λ and ``initial_wait`` are
    **ceiled** (never less load) — so a cache hit can over-provision but
    can never admit a decision the exact constraint set rejects.  With
    every quantum at 0 the key is the exact input and memoization cannot
    change a decision, only deduplicate identical states.  Cache hits
    return the stored Decision verbatim (``solver_time``/``solver_iters``
    describe the original miss); ``hits``/``misses``/``hit_rate`` expose
    the cache economics.  Eviction is clear-on-full at
    ``max_entries``.
    """

    def __init__(self, budget_quantum: float = 0.0,
                 lam_quantum: float = 0.0, max_entries: int = 200_000):
        self.budget_quantum = float(budget_quantum)
        self.lam_quantum = float(lam_quantum)
        self.max_entries = max_entries
        self.cache: dict = {}
        self.hits = 0
        self.misses = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of ``solve`` calls answered from the cache."""
        return self.hits / max(self.hits + self.misses, 1)

    def _quantize(self, rem: np.ndarray, lam: float, initial_wait: float
                  ) -> tuple[np.ndarray, float, float]:
        """Floor budgets, ceil λ/wait to their quanta (0 = exact)."""
        bq, lq = self.budget_quantum, self.lam_quantum
        if bq > 0:
            rem = np.floor(rem / bq) * bq
            iw = float(np.ceil(initial_wait / bq) * bq)
        else:
            iw = float(initial_wait)
        lam_q = float(np.ceil(lam / lq) * lq) if lq > 0 else float(lam)
        return rem, lam_q, iw

    def _cached(self, key, compute) -> Decision:
        """One hit/miss round trip; ``compute`` runs on a miss."""
        d = self.cache.get(key)
        if d is not None:
            self.hits += 1
            return d
        self.misses += 1
        d = compute()
        if len(self.cache) >= self.max_entries:
            self.cache.clear()
        self.cache[key] = d
        return d


class MemoizedSolver(_QuantizedDecisionCache):
    """Decision cache in front of a :class:`SolverTable` — the
    :class:`_QuantizedDecisionCache` bucketing over the fixed-work
    Algorithm 1 (the million-request scenario-engine configuration)."""

    def __init__(self, perf: Union[PerfModel, CostModel],
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 budget_quantum: float = 0.0, lam_quantum: float = 0.0,
                 max_entries: int = 200_000):
        super().__init__(budget_quantum, lam_quantum, max_entries)
        self.table = SolverTable(perf, c_set, b_set)

    def solve(self, remaining_slos, lam: float,
              initial_wait: float = 0.0) -> Decision:
        """Quantize conservatively, then cache per bucket signature."""
        rem = np.sort(np.asarray(remaining_slos, np.float64).ravel())
        rem, lam_q, iw = self._quantize(rem, lam, initial_wait)
        return self._cached(
            (rem.tobytes(), lam_q, iw),
            lambda: self.table.solve(rem, lam_q, initial_wait=iw))

    def solve_many(self, remaining_slos_seq, lams, initial_waits=None
                   ) -> List[Decision]:
        """Batch decision lookup: quantize every (λ, wait) scalar in two
        vectorized passes and probe the cache per item, falling back to
        the table only on misses.  Elementwise identical to calling
        :meth:`solve` in sequence (the cache is exact per quantized key),
        but amortizes the per-call numpy scalar overhead — the shape the
        vectorized control plane and RL-scale rollout loops batch their
        per-tick lookups in.
        """
        n = len(remaining_slos_seq)
        lams = np.asarray(lams, np.float64)
        iws = (np.zeros(n) if initial_waits is None
               else np.asarray(initial_waits, np.float64))
        lq, bq = self.lam_quantum, self.budget_quantum
        lams_q = (np.ceil(lams / lq) * lq if lq > 0 else lams)
        iws_q = (np.ceil(iws / bq) * bq if bq > 0 else iws)
        out: List[Decision] = []
        for k in range(n):
            rem = np.sort(np.asarray(remaining_slos_seq[k],
                                     np.float64).ravel())
            if bq > 0:
                rem = np.floor(rem / bq) * bq
            lam_q, iw = float(lams_q[k]), float(iws_q[k])
            out.append(self._cached(
                (rem.tobytes(), lam_q, iw),
                lambda: self.table.solve(rem, lam_q, initial_wait=iw)))
        return out


# ---------------------------------------------------------------------------
# joint horizontal + vertical scaling (the fleet layer)
# ---------------------------------------------------------------------------
def joint_candidates(c_set: Sequence[int], b_set: Sequence[int],
                     n_set: Sequence[int], replica_pen: float = 0.0):
    """The joint search order: every ``(n, c, b)`` triple sorted by
    ``(n*c + replica_pen*n, n, b)`` ascending — cheapest total core
    allocation first, fewer replicas on ties (less management churn,
    fewer cold starts), then smallest batch.  Returning the first
    feasible candidate in this order makes the joint solve the
    lexicographic optimum of the fleet IP (minimize total core-seconds
    ``n*c``), exactly as Algorithm 1's (c, b) iteration order does for
    the single-replica IP.

    ``replica_pen`` charges each replica a fixed core-equivalent
    overhead (control plane, weight duplication, cold-start exposure).
    At 0 the objective is pure total cores — which systematically
    prefers wide fleets of 1-core replicas (Amdahl makes low c the most
    core-efficient) whose thin latency margins amplify routing
    imbalance; a fraction of a core per replica restores the paper's
    vertical-first behavior (scale up in place, go horizontal only when
    the vertical axis saturates)."""
    return sorted((n * c + replica_pen * n, n, b, c)
                  for n in sorted(set(int(x) for x in n_set))
                  for c in sorted(set(int(x) for x in c_set))
                  for b in sorted(set(int(x) for x in b_set)))


def solve_joint_bruteforce(remaining_slos: Sequence[float], lam: float,
                           perf: Union[PerfModel, CostModel],
                           c_set: Sequence[int] = DEFAULT_C,
                           b_set: Sequence[int] = DEFAULT_B,
                           n_set: Sequence[int] = DEFAULT_N,
                           initial_wait: float = 0.0,
                           replica_pen: float = 0.0) -> Decision:
    """Algorithm 1 lifted to the fleet: pick ``(n, c, b)`` together.

    A fleet of ``n`` replicas, each vertically scaled to ``c`` cores and
    batching up to ``b``, drains the global EDF queue as a *striped*
    split: the k-th tightest request lands on replica ``k mod n``, so
    the fleet consumes EDF groups of ``n*b`` requests per batch round
    and every round takes one batch latency ``l(b, c)``.  The
    constraint set is therefore exactly Algorithm 1's with the group
    size ``b`` replaced by ``n*b`` and throughput ``n · h(b, c)``:

    * group i (0-indexed) finishes at ``initial_wait + (i+1)·l(b, c)``
      and must meet its head request's remaining budget ``rem[i·n·b]``;
    * sustained throughput ``n·b / l(b, c) >= λ``.

    Candidates are searched in :func:`joint_candidates` order (total
    cores ``n*c`` ascending), so the first feasible triple minimizes the
    fleet's total core allocation.  With ``n_set=(1,)`` this degenerates
    to :func:`solve_bruteforce` decision-for-decision (a reduction the
    fleet tests property-check).  The infeasible fallback
    mirrors ``solve_bruteforce``: among λ-sustaining candidates, fewest
    predicted violations, ties broken by fastest drain.
    """
    t0 = time.perf_counter()
    rem = sorted(float(x) for x in remaining_slos)
    n_req = len(rem)
    iters = 0
    best_fallback = None  # (key, n, c, b)
    for _total, n, b, c in joint_candidates(c_set, b_set, n_set,
                                            replica_pen):
        iters += 1
        l = float(perf.latency(b, c))
        thr = n * float(perf.throughput(b, c))
        if lam > 0 and thr < lam:
            continue
        g = n * b
        ok = True
        q_r = initial_wait
        for i in range(0, max(n_req, 1), g):
            budget = rem[i] if n_req else float("inf")
            if l + q_r > budget:
                ok = False
                break
            q_r += l
            if n_req == 0:
                break
        if ok:
            return Decision(c=c, b=b, n=n, feasible=True,
                            solver_iters=iters,
                            solver_time=time.perf_counter() - t0)
        v = _predicted_violations(rem, l, g, initial_wait)
        key = (v, -thr)
        if best_fallback is None or key < best_fallback[0]:
            best_fallback = (key, n, c, b)
    if best_fallback is None:  # nothing sustains lam: max capacity config
        n = max(n_set)
        c = max(c_set)
        b = max(b_set, key=lambda bb: float(perf.throughput(bb, c)))
        best_fallback = ((n_req, 0.0), n, c, b)
    _, n, c, b = best_fallback
    return Decision(c=c, b=b, n=n, feasible=False, solver_iters=iters,
                    solver_time=time.perf_counter() - t0)


class JointSolverTable:
    """Vectorized joint ``(n, c, b)`` Algorithm 1 over precomputed grids.

    Shares the latency/throughput grids of a :class:`SolverTable` (they
    depend only on ``(perf, c_set, b_set)``) and pre-sorts the joint
    candidate order once (:func:`joint_candidates`).  ``solve`` answers
    each query with one vectorized drain check per ``(n, b)`` pair over
    all core counts at once; constraint set and fallback are exactly
    :func:`solve_joint_bruteforce`'s, term for term, so the two agree
    decision-for-decision (property-tested by the fleet tests).

    ``only_n`` pins the replica count — the hysteresis re-solve path
    (``repro_torch.serving.fleet.FleetSpongeScaler`` blocks a scale-down
    until the target persists, re-solving ``(c, b)`` at the current fleet
    size in the meantime).  ``max_cores`` caps the total allocation
    ``n*c`` — the reference's multi-tenant pool (``serving.tenancy``)
    solves each tenant under its current core cap, and
    :meth:`min_violations` reads the same feasibility frontier to price
    a core transfer between tenants.
    """

    def __init__(self, perf: Union[PerfModel, CostModel],
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 n_set: Sequence[int] = DEFAULT_N,
                 replica_pen: float = 0.0):
        self.base = SolverTable(perf, c_set, b_set)
        self.perf = perf
        self.replica_pen = float(replica_pen)
        self.ns = np.asarray(sorted(set(int(x) for x in n_set)), np.int64)
        cands = joint_candidates(c_set, b_set, n_set, replica_pen)
        self.order_n = np.asarray([n for _, n, _, _ in cands], np.int64)
        self.order_b = np.asarray([b for _, _, b, _ in cands], np.int64)
        self.order_c = np.asarray([c for _, _, _, c in cands], np.int64)
        # map each ordered candidate to its (n, c, b) grid cell
        n_pos = {int(n): i for i, n in enumerate(self.ns)}
        c_pos = {int(c): i for i, c in enumerate(self.base.cs)}
        b_pos = {int(b): j for j, b in enumerate(self.base.bs)}
        self._flat = np.asarray(
            [(n_pos[int(n)] * self.base.lat.size
              + c_pos[int(c)] * len(self.base.bs) + b_pos[int(b)])
             for _, n, b, c in cands], np.int64)
        self._total = self.order_n * self.order_c   # cores per candidate
        self.size = len(cands)
        self._max_rate_cache: dict = {}

    def solve(self, remaining_slos, lam: float, initial_wait: float = 0.0,
              only_n: Optional[int] = None,
              max_cores: Optional[int] = None) -> Decision:
        """Joint solve; same inputs/semantics as
        :func:`solve_joint_bruteforce` (plus the ``only_n`` pin and the
        ``max_cores`` total-allocation cap)."""
        t0 = time.perf_counter()
        rem = np.sort(np.asarray(remaining_slos, np.float64).ravel())
        n_req = rem.size
        lat, thr = self.base.lat, self.base.thr          # (C, B)
        C, B = lat.shape
        N = len(self.ns)
        feas = np.ones((N, C, B), bool)
        thr_n = self.ns[:, None, None] * thr[None]       # (N, C, B)
        if lam > 0:
            feas &= thr_n >= lam
        sustain = feas.copy()
        if n_req:
            for i, n in enumerate(self.ns):
                for j in range(B):
                    g = int(n) * int(self.base.bs[j])
                    heads = rem[::g]
                    k = np.arange(1, heads.size + 1, dtype=np.float64)
                    finish = initial_wait + lat[:, j, None] * k
                    feas[i, :, j] &= (finish <= heads).all(axis=1)
        ok = feas.reshape(-1)[self._flat]
        if only_n is not None:
            ok = ok & (self.order_n == only_n)
        if max_cores is not None:
            ok = ok & (self._total <= max_cores)
        hit = np.flatnonzero(ok)
        if hit.size:
            i = int(hit[0])
            return Decision(c=int(self.order_c[i]), b=int(self.order_b[i]),
                            n=int(self.order_n[i]), feasible=True,
                            solver_iters=self.size,
                            solver_time=time.perf_counter() - t0)
        # fallback: among λ-sustaining candidates, fewest predicted
        # violations, then max fleet throughput, then candidate order
        sus = sustain.reshape(-1)[self._flat]
        if only_n is not None:
            sus = sus & (self.order_n == only_n)
        if max_cores is not None:
            sus = sus & (self._total <= max_cores)
        if sus.any():
            viol = np.zeros((N, C, B), np.int64)
            if n_req:
                idx = np.arange(n_req, dtype=np.int64)
                for i, n in enumerate(self.ns):
                    for j in range(B):
                        g = int(n) * int(self.base.bs[j])
                        mult = (idx // g + 1).astype(np.float64)
                        finish = initial_wait + lat[:, j, None] * mult
                        viol[i, :, j] = (finish > rem).sum(axis=1)
            key1 = np.where(sus, viol.reshape(-1)[self._flat]
                            .astype(np.float64), np.inf)
            cand = np.flatnonzero(key1 == key1.min())
            thr_flat = thr_n.reshape(-1)[self._flat][cand]
            i = int(cand[np.flatnonzero(thr_flat == thr_flat.max())[0]])
            n, c, b = (int(self.order_n[i]), int(self.order_c[i]),
                       int(self.order_b[i]))
        elif max_cores is None:   # nothing sustains lam: max capacity
            n = int(only_n if only_n is not None else self.ns[-1])
            c = int(self.base.cs[-1])
            j = int(np.argmax(self.base.thr[-1]))
            b = int(self.base.bs[j])
        else:
            # capped overload: the largest fleet throughput that still
            # fits the core cap (honouring the pin when possible), so a
            # starved tenant saturates its slice rather than claiming
            # cores the pool never granted
            fit = self._total <= max_cores
            if only_n is not None and (fit & (self.order_n == only_n)).any():
                fit = fit & (self.order_n == only_n)
            if fit.any():
                key = np.where(fit, thr_n.reshape(-1)[self._flat]
                               .astype(np.float64), -np.inf)
                cand = np.flatnonzero(key == key.max())
                tot = self._total[cand]
                i = int(cand[np.flatnonzero(tot == tot.min())[0]])
            else:        # cap below every candidate: cheapest config
                i = 0
            n, c, b = (int(self.order_n[i]), int(self.order_c[i]),
                       int(self.order_b[i]))
        return Decision(c=c, b=b, n=n, feasible=False,
                        solver_iters=self.size,
                        solver_time=time.perf_counter() - t0)

    def min_violations(self, remaining_slos, lam: float,
                       initial_wait: float = 0.0,
                       max_cores: Optional[int] = None,
                       sustaining_pool: bool = True) -> int:
        """Fewest predicted EDF violations achievable under ``max_cores``.

        Reads the same frontier as :meth:`solve`: ``0`` when any
        candidate under the cap drains the queue in time, otherwise the
        minimum of the predicted-violation grid among λ-sustaining
        candidates under the cap (falling back to every candidate under
        the cap, then to the whole queue length when the cap excludes
        every candidate).  This is the value function ``V(cap)`` that
        the reference's multi-tenant reallocator (``serving.tenancy``)
        differentiates to price a core transfer between tenants.

        ``sustaining_pool=False`` skips the λ-sustaining preference and
        minimizes over every candidate under the cap — the pool the
        (m, n, c, b) fallback needs, because cross-rung counts are only
        comparable when every rung minimizes over the same grid (a
        sustaining-restricted pool can report *more* violations for a
        strictly faster rung).
        """
        rem = np.sort(np.asarray(remaining_slos, np.float64).ravel())
        n_req = rem.size
        if n_req == 0:
            return 0
        lat, thr = self.base.lat, self.base.thr          # (C, B)
        C, B = lat.shape
        N = len(self.ns)
        feas = np.ones((N, C, B), bool)
        thr_n = self.ns[:, None, None] * thr[None]       # (N, C, B)
        if lam > 0:
            feas &= thr_n >= lam
        sustain = feas.copy()
        for i, n in enumerate(self.ns):
            for j in range(B):
                g = int(n) * int(self.base.bs[j])
                heads = rem[::g]
                k = np.arange(1, heads.size + 1, dtype=np.float64)
                finish = initial_wait + lat[:, j, None] * k
                feas[i, :, j] &= (finish <= heads).all(axis=1)
        fit = (np.ones(self.size, bool) if max_cores is None
               else self._total <= max_cores)
        if (feas.reshape(-1)[self._flat] & fit).any():
            return 0
        viol = np.zeros((N, C, B), np.int64)
        idx = np.arange(n_req, dtype=np.int64)
        for i, n in enumerate(self.ns):
            for j in range(B):
                g = int(n) * int(self.base.bs[j])
                mult = (idx // g + 1).astype(np.float64)
                finish = initial_wait + lat[:, j, None] * mult
                viol[i, :, j] = (finish > rem).sum(axis=1)
        sus = sustain.reshape(-1)[self._flat] & fit
        pool = sus if (sustaining_pool and sus.any()) else fit
        if not pool.any():
            return n_req
        return int(viol.reshape(-1)[self._flat][pool].min())

    def max_rate(self, max_cores: Optional[int] = None) -> float:
        """Highest arrival rate any candidate under ``max_cores``
        sustains — the fleet throughput ceiling of the capped frontier
        (the same ``n·thr`` surface :meth:`solve` tests ``λ`` against).
        Arrivals beyond this rate are un-servable at the cap no matter
        the backlog, which is what lets the multi-tenant reallocator
        price a core transfer *before* the queue melts down.  Cached per
        cap (the grid never changes)."""
        key = -1 if max_cores is None else int(max_cores)
        hit = self._max_rate_cache.get(key)
        if hit is not None:
            return hit
        thr_n = (self.ns[:, None, None] *
                 self.base.thr[None]).reshape(-1)[self._flat]
        fit = (np.ones(self.size, bool) if max_cores is None
               else self._total <= max_cores)
        val = float(thr_n[fit].max()) if fit.any() else 0.0
        self._max_rate_cache[key] = val
        return val


class JointMemoizedSolver(_QuantizedDecisionCache):
    """Quantized decision cache in front of a :class:`JointSolverTable`
    — the shared :class:`_QuantizedDecisionCache` bucketing with the
    replica pin ``only_n`` folded into the cache key."""

    def __init__(self, perf: Union[PerfModel, CostModel],
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 n_set: Sequence[int] = DEFAULT_N,
                 budget_quantum: float = 0.0, lam_quantum: float = 0.0,
                 replica_pen: float = 0.0, max_entries: int = 200_000):
        super().__init__(budget_quantum, lam_quantum, max_entries)
        self.table = JointSolverTable(perf, c_set, b_set, n_set,
                                      replica_pen)

    def solve(self, remaining_slos, lam: float, initial_wait: float = 0.0,
              only_n: Optional[int] = None,
              max_cores: Optional[int] = None) -> Decision:
        """Quantize conservatively, then cache per bucket signature."""
        rem = np.sort(np.asarray(remaining_slos, np.float64).ravel())
        rem, lam_q, iw = self._quantize(rem, lam, initial_wait)
        return self._cached(
            (rem.tobytes(), lam_q, iw, only_n, max_cores),
            lambda: self.table.solve(rem, lam_q, initial_wait=iw,
                                     only_n=only_n, max_cores=max_cores))


# ---------------------------------------------------------------------------
# (m, n, c, b): the model-size axis (accuracy degradation)
# ---------------------------------------------------------------------------
def _joint_min_violations_bruteforce(rem, lam: float, perf, c_set, b_set,
                                     n_set, initial_wait: float,
                                     max_cores: Optional[int] = None,
                                     sustaining_pool: bool = True) -> int:
    """Loop-and-count reference for ``JointSolverTable.min_violations``
    (same tier structure: 0 if any candidate drains in time, else the
    minimum over λ-sustaining candidates, else over all candidates,
    else the whole queue; ``sustaining_pool=False`` minimizes over all
    candidates directly — the cross-rung-comparable pool)."""
    rem = sorted(float(x) for x in rem)
    n_req = len(rem)
    if n_req == 0:
        return 0
    best_sus = None
    best_any = None
    for _total, n, b, c in joint_candidates(c_set, b_set, n_set):
        if max_cores is not None and n * c > max_cores:
            continue
        l = float(perf.latency(b, c))
        v = _predicted_violations(rem, l, n * b, initial_wait)
        sustains = lam <= 0 or n * float(perf.throughput(b, c)) >= lam
        if sustains and (best_sus is None or v < best_sus):
            best_sus = v
        if best_any is None or v < best_any:
            best_any = v
    if sustaining_pool and best_sus is not None:
        return best_sus
    if best_any is not None:
        return best_any
    return n_req


def solve_multimodel_bruteforce(remaining_slos, lam: float, ladder,
                                c_set: Sequence[int] = DEFAULT_C,
                                b_set: Sequence[int] = DEFAULT_B,
                                n_set: Sequence[int] = DEFAULT_N,
                                initial_wait: float = 0.0,
                                replica_pen: float = 0.0,
                                accuracy_floor: float = 0.0,
                                m_set: Optional[Sequence[str]] = None,
                                current_m: Optional[str] = None,
                                ) -> Decision:
    """The (m, n, c, b) reference solver: Algorithm 1 lifted to the
    fleet *and* the model ladder.

    Rungs are searched in accuracy-descending order (the
    ``ModelLadder`` iteration order), each via the joint (n, c, b)
    solve on the rung's own cost surface; the first rung with any
    feasible allocation wins.  Accuracy is therefore **shed only when
    no (n, c, b) at every higher rung is feasible** — the candidate
    order prefers higher-accuracy models unconditionally, making the
    shed provable rather than a weighted trade-off.

    ``accuracy_floor`` removes rungs below the SLO's quality floor
    from the search entirely; ``m_set`` pins the admissible rungs (a
    single-name pin reduces to :func:`solve_joint_bruteforce` on that
    rung, decision-for-decision).  ``current_m`` makes the search
    swap-cost-aware: any rung other than the currently loaded model
    charges its weights-load time on top of ``initial_wait`` (the
    fleet cannot serve on a rung before its weights arrive), so a
    degradation must be worth its own swap.

    When no admissible rung has a feasible allocation, the fallback
    compares rungs by (1) fewest predicted queued violations, counted
    over *every* (n, c, b) candidate (the only pool in which a strictly
    faster rung can never report more violations), then (2) the largest
    capacity-accuracy product ``min(lam, ceiling) * accuracy`` — the
    sustainable accuracy-weighted serve rate, which hands the win to
    the highest-accuracy rung that absorbs ``lam`` and degrades
    smoothly to throughput damage control when nothing does — then
    (3) higher accuracy (earlier in the ladder), and returns that
    rung's damage-minimizing joint fallback.
    """
    t0 = time.perf_counter()
    rungs = ladder.admissible(accuracy_floor, m_set)
    iters = 0
    best = None          # ((violations, -capacity*acc), rung, decision)
    for rung in rungs:
        iw = initial_wait
        if current_m is not None and rung.name != current_m:
            iw = initial_wait + float(rung.swap_cost)
        d = solve_joint_bruteforce(remaining_slos, lam, rung.cost,
                                   c_set, b_set, n_set,
                                   initial_wait=iw,
                                   replica_pen=replica_pen)
        iters += d.solver_iters
        if d.feasible:
            return replace(d, m=rung.name, solver_iters=iters,
                           solver_time=time.perf_counter() - t0)
        v = _joint_min_violations_bruteforce(
            remaining_slos, lam, rung.cost, c_set, b_set, n_set, iw,
            sustaining_pool=False)
        ceiling = max(n * float(rung.cost.throughput(b, c))
                      for _t, n, b, c in joint_candidates(c_set, b_set,
                                                          n_set))
        key = (v, -min(max(lam, 0.0), ceiling) * rung.accuracy)
        if best is None or key < best[0]:
            best = (key, rung, d)
    _, rung, d = best
    return replace(d, m=rung.name, solver_iters=iters,
                   solver_time=time.perf_counter() - t0)


class MultiModelSolverTable:
    """The (m, n, c, b) solver: one :class:`JointSolverTable` per
    ladder rung, searched in accuracy-descending order.

    Semantics are exactly :func:`solve_multimodel_bruteforce`'s, rung
    for rung: accuracy is shed only when every (n, c, b) at every
    higher admissible rung is infeasible, ``accuracy_floor`` bounds
    the shed, ``current_m`` charges non-resident rungs their
    weights-load time, and the all-infeasible fallback returns the
    damage-minimizing decision of the best rung under the ordering
    (fewest predicted violations over the all-candidate pool, largest
    capacity-accuracy product under the core cap, higher accuracy).

    **Pinned-m reduction**: with ``m_set=(rung,)`` and no swap charge
    (``current_m`` absent or equal to the pin) the solve is a single
    delegation to that rung's :class:`JointSolverTable` — bit-identical
    to the joint solver by construction, with only the ``m`` tag
    added (property-tested by the degradation tests).
    """

    def __init__(self, ladder, c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 n_set: Sequence[int] = DEFAULT_N,
                 replica_pen: float = 0.0):
        self.ladder = ladder
        self.tables = {
            rung.name: JointSolverTable(rung.cost, c_set, b_set, n_set,
                                        replica_pen)
            for rung in ladder}
        self.size = sum(t.size for t in self.tables.values())

    def _rung_wait(self, rung, initial_wait: float,
                   current_m: Optional[str]) -> float:
        if current_m is not None and rung.name != current_m:
            return initial_wait + float(rung.swap_cost)
        return initial_wait

    def solve(self, remaining_slos, lam: float, initial_wait: float = 0.0,
              only_n: Optional[int] = None,
              max_cores: Optional[int] = None,
              accuracy_floor: float = 0.0,
              m_set: Optional[Sequence[str]] = None,
              current_m: Optional[str] = None) -> Decision:
        t0 = time.perf_counter()
        rungs = self.ladder.admissible(accuracy_floor, m_set)
        if len(rungs) == 1:
            # the pinned-m reduction: pure delegation (bit-identical
            # to JointSolverTable.solve on that rung, m tag aside)
            rung = rungs[0]
            d = self.tables[rung.name].solve(
                remaining_slos, lam,
                initial_wait=self._rung_wait(rung, initial_wait,
                                             current_m),
                only_n=only_n, max_cores=max_cores)
            return replace(d, m=rung.name)
        iters = 0
        best = None          # ((violations, -capacity*acc), rung, decision)
        for rung in rungs:
            iw = self._rung_wait(rung, initial_wait, current_m)
            table = self.tables[rung.name]
            d = table.solve(remaining_slos, lam, initial_wait=iw,
                            only_n=only_n, max_cores=max_cores)
            iters += d.solver_iters
            if d.feasible:
                return replace(d, m=rung.name, solver_iters=iters,
                               solver_time=time.perf_counter() - t0)
            # violations counted over the all-candidate pool — the only
            # pool in which a strictly faster rung can never report
            # more violations — then the capacity-accuracy product
            # min(lam, ceiling)*acc: the sustainable accuracy-weighted
            # serve rate (blind queued counts cannot see that a rung
            # which absorbs lam stops the backlog growing)
            v = table.min_violations(remaining_slos, lam, initial_wait=iw,
                                     max_cores=max_cores,
                                     sustaining_pool=False)
            cap_acc = (min(max(lam, 0.0), table.max_rate(max_cores))
                       * rung.accuracy)
            key = (v, -cap_acc)
            if best is None or key < best[0]:
                best = (key, rung, d)
        _, rung, d = best
        return replace(d, m=rung.name, solver_iters=iters,
                       solver_time=time.perf_counter() - t0)


class MultiModelMemoizedSolver(_QuantizedDecisionCache):
    """Quantized decision cache in front of a
    :class:`MultiModelSolverTable` — the shared conservative bucketing
    with the degradation knobs (floor, rung pin, resident model)
    folded into the cache key."""

    def __init__(self, ladder, c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 n_set: Sequence[int] = DEFAULT_N,
                 budget_quantum: float = 0.0, lam_quantum: float = 0.0,
                 replica_pen: float = 0.0, max_entries: int = 200_000):
        super().__init__(budget_quantum, lam_quantum, max_entries)
        self.table = MultiModelSolverTable(ladder, c_set, b_set, n_set,
                                           replica_pen)

    def solve(self, remaining_slos, lam: float, initial_wait: float = 0.0,
              only_n: Optional[int] = None,
              max_cores: Optional[int] = None,
              accuracy_floor: float = 0.0,
              m_set: Optional[Sequence[str]] = None,
              current_m: Optional[str] = None) -> Decision:
        rem = np.sort(np.asarray(remaining_slos, np.float64).ravel())
        rem, lam_q, iw = self._quantize(rem, lam, initial_wait)
        pins = None if m_set is None else tuple(m_set)
        return self._cached(
            (rem.tobytes(), lam_q, iw, only_n, max_cores,
             round(float(accuracy_floor), 12), pins, current_m),
            lambda: self.table.solve(rem, lam_q, initial_wait=iw,
                                     only_n=only_n, max_cores=max_cores,
                                     accuracy_floor=accuracy_floor,
                                     m_set=pins, current_m=current_m))


def _token_edf_order(ttft_budgets, prompt_tokens):
    """Sort (budget, tokens) pairs by budget ascending (EDF), stably."""
    rem = np.asarray(ttft_budgets, np.float64).ravel()
    toks = np.asarray(prompt_tokens, np.float64).ravel()
    assert rem.shape == toks.shape, (rem.shape, toks.shape)
    order = np.argsort(rem, kind="stable")
    return rem[order], toks[order]


def _group_token_sums(toks: np.ndarray, b: int) -> np.ndarray:
    """Total prompt tokens of each EDF group of b (last group ragged)."""
    n = toks.size
    g = (n + b - 1) // b
    padded = np.zeros(g * b, np.float64)
    padded[:n] = toks
    return padded.reshape(g, b).sum(axis=1)


def solve_token_bruteforce(ttft_budgets, prompt_tokens, lam: float,
                           cost: TokenCostModel,
                           c_set: Sequence[int] = DEFAULT_C,
                           b_set: Sequence[int] = DEFAULT_B,
                           initial_wait: float = 0.0,
                           tbt_budget: float = float("inf"),
                           active_slots: int = 0,
                           mean_decode: Optional[float] = None,
                           drag_steps: Optional[float] = None) -> Decision:
    """Algorithm 1 extended to token compositions — reference semantics.

    Iterate c ascending then b ascending and return the first (c, b)
    that satisfies all three constraint families (the lexicographic IP
    optimum, exactly as in the fixed-work solver):

    * **TBT**: ``decode_latency(c, b) <= tbt_budget`` whenever a decode
      stream exists (``active_slots > 0`` or the workload decodes at
      all) — b is the decode-slot cap the engine runs at;
    * **λ**: full-service throughput ``cost.throughput(b, c) >= lam``;
    * **TTFT**: EDF groups of b prefill in order; group i finishes at
      ``initial_wait + Σ_{j<=i} (prefill_latency(c, T_j) + drag)`` and
      must meet its head request's remaining TTFT budget.  ``drag`` is
      ``drag_steps`` decode steps at concurrency b when a decode stream
      exists — the time a full group of slots takes to turn over before
      the next group's prompts can join (default: the mean decode
      length, i.e. a slot frees when its stream finishes), else 0.

    The infeasible fallback mirrors ``solve_bruteforce``: fewest
    predicted TTFT violations among λ-sustaining configs, ties broken by
    fastest drain.
    """
    t0 = time.perf_counter()
    rem, toks = _token_edf_order(ttft_budgets, prompt_tokens)
    n = rem.size
    md = cost.mean_decode if mean_decode is None else mean_decode
    decode_present = active_slots > 0 or md > 0
    dsteps = md if drag_steps is None else drag_steps
    iters = 0
    best_fallback = None
    for c in sorted(c_set):
        for b in sorted(b_set):
            iters += 1
            l_d = float(cost.decode_latency(c, b))
            if decode_present and l_d > tbt_budget:
                continue
            if lam > 0 and float(cost.throughput(b, c)) < lam:
                continue
            drag = l_d * dsteps if decode_present else 0.0
            ok = True
            viol = 0
            q_r = initial_wait
            if n:
                sums = _group_token_sums(toks, b)
                for i, T in enumerate(sums):
                    step = float(cost.prefill_latency(c, T)) + drag
                    finish = q_r + step
                    head = rem[i * b]
                    if finish > head:
                        ok = False
                        viol += int((finish
                                     > rem[i * b:(i + 1) * b]).sum())
                    elif not ok:
                        viol += int((finish
                                     > rem[i * b:(i + 1) * b]).sum())
                    q_r = finish
            if ok:
                return Decision(c=c, b=b, feasible=True, solver_iters=iters,
                                solver_time=time.perf_counter() - t0,
                                predicted_tbt=l_d)
            key = (viol, -float(cost.throughput(b, c)))
            if best_fallback is None or key < best_fallback[0]:
                best_fallback = (key, c, b, l_d)
    if best_fallback is None:       # nothing passes TBT+λ: max capacity
        c = max(c_set)
        b = max(b_set, key=lambda bb: float(cost.throughput(bb, c)))
        best_fallback = ((n, 0.0), c, b, float(cost.decode_latency(c, b)))
    _, c, b, l_d = best_fallback
    return Decision(c=c, b=b, feasible=False, solver_iters=iters,
                    solver_time=time.perf_counter() - t0, predicted_tbt=l_d)


class TokenSolverTable:
    """Vectorized token-level Algorithm 1 over precomputed (c, b) grids.

    The decode-step latency grid, full-service throughput grid and the
    (c, b) lexicographic iteration order depend only on
    (cost, c_set, b_set) and are computed once; ``solve`` answers each
    query with one vectorized pass per batch size (prefill latencies of
    the EDF token groups, a cumulative drain, comparisons against the
    group heads).  Constraint set and fallback are exactly
    :func:`solve_token_bruteforce`'s — the float expressions are shared
    term for term (including the sequential accumulation order of the
    drain), so the two agree decision-for-decision.
    """

    def __init__(self, cost: TokenCostModel,
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B):
        self.cost = cost
        self.cs = np.asarray(sorted(c_set), np.int64)
        self.bs = np.asarray(sorted(b_set), np.int64)
        cc, bb = np.meshgrid(self.cs, self.bs, indexing="ij")     # (C, B)
        self.dec = np.asarray(cost.decode_latency(cc.astype(np.float64), bb),
                              np.float64)
        self.thr = np.asarray(cost.throughput(bb, cc), np.float64)
        self.c_flat = cc.ravel()
        self.b_flat = bb.ravel()
        self.size = self.dec.size

    def solve(self, ttft_budgets, prompt_tokens, lam: float,
              initial_wait: float = 0.0,
              tbt_budget: float = float("inf"),
              active_slots: int = 0,
              mean_decode: Optional[float] = None,
              drag_steps: Optional[float] = None) -> Decision:
        """Token-composition solve; same inputs and semantics as
        :func:`solve_token_bruteforce`."""
        t0 = time.perf_counter()
        rem, toks = _token_edf_order(ttft_budgets, prompt_tokens)
        n = rem.size
        md = self.cost.mean_decode if mean_decode is None else mean_decode
        decode_present = active_slots > 0 or md > 0
        dsteps = md if drag_steps is None else drag_steps
        C, B = self.dec.shape
        tbt_ok = (self.dec <= tbt_budget) if decode_present \
            else np.ones((C, B), bool)
        sustain = (self.thr >= lam) if lam > 0 else np.ones((C, B), bool)
        feas = tbt_ok & sustain
        viol = np.zeros((C, B), np.int64)
        cf = self.cs.astype(np.float64)
        if n:
            for j in range(B):
                b = int(self.bs[j])
                sums = _group_token_sums(toks, b)               # (g,)
                lp = np.asarray(self.cost.prefill_latency(
                    cf[:, None], sums[None, :]), np.float64)    # (C, g)
                drag = (self.dec[:, j, None] * dsteps
                        if decode_present else 0.0)
                steps = lp + drag
                # fold initial_wait into the first step so the cumulative
                # sum reproduces the bruteforce's sequential additions
                # ((iw + s0) + s1 ...) bit for bit
                steps[:, 0] += initial_wait
                finish = np.cumsum(steps, axis=1)               # (C, g)
                heads = rem[::b]                                # (g,)
                feas[:, j] &= (finish <= heads[None, :]).all(axis=1)
                per_req = np.repeat(finish, b, axis=1)[:, :n]   # (C, n)
                viol[:, j] = (per_req > rem[None, :]).sum(axis=1)
        ok = feas.ravel()
        hit = np.flatnonzero(ok)
        if hit.size:
            i = int(hit[0])
            return Decision(c=int(self.c_flat[i]), b=int(self.b_flat[i]),
                            feasible=True, solver_iters=self.size,
                            solver_time=time.perf_counter() - t0,
                            predicted_tbt=float(self.dec.ravel()[i]))
        pool = tbt_ok & sustain
        pool_flat = pool.ravel()
        if pool_flat.any():
            key1 = np.where(pool_flat, viol.ravel().astype(np.float64),
                            np.inf)
            cand = np.flatnonzero(key1 == key1.min())
            thr_c = self.thr.ravel()[cand]
            i = int(cand[np.flatnonzero(thr_c == thr_c.max())[0]])
            c, b = int(self.c_flat[i]), int(self.b_flat[i])
            l_d = float(self.dec.ravel()[i])
        else:                   # nothing passes TBT+λ: max capacity
            c = int(self.cs[-1])
            j = int(np.argmax(self.thr[-1]))
            b = int(self.bs[j])
            l_d = float(self.dec[-1, j])
        return Decision(c=c, b=b, feasible=False, solver_iters=self.size,
                        solver_time=time.perf_counter() - t0,
                        predicted_tbt=l_d)


class TokenMemoizedSolver(_QuantizedDecisionCache):
    """Quantized decision cache in front of a :class:`TokenSolverTable`.

    The shared :class:`_QuantizedDecisionCache` bucketing, extended to
    the token inputs with the same conservative direction:

    * the TBT budget is *floored* to ``budget_quantum`` — cached
      decisions never assume more per-token slack;
    * prompt-token counts are *ceiled* to ``token_quantum`` tokens —
      never less work.
    """

    def __init__(self, cost: TokenCostModel,
                 c_set: Sequence[int] = DEFAULT_C,
                 b_set: Sequence[int] = DEFAULT_B,
                 budget_quantum: float = 0.0, lam_quantum: float = 0.0,
                 token_quantum: int = 0, max_entries: int = 200_000):
        super().__init__(budget_quantum, lam_quantum, max_entries)
        self.table = TokenSolverTable(cost, c_set, b_set)
        self.token_quantum = int(token_quantum)

    def solve(self, ttft_budgets, prompt_tokens, lam: float,
              initial_wait: float = 0.0,
              tbt_budget: float = float("inf"),
              active_slots: int = 0,
              mean_decode: Optional[float] = None,
              drag_steps: Optional[float] = None) -> Decision:
        """Quantize conservatively, then cache per bucket signature."""
        rem, toks = _token_edf_order(ttft_budgets, prompt_tokens)
        rem, lam_q, iw = self._quantize(rem, lam, initial_wait)
        bq, tq = self.budget_quantum, self.token_quantum
        tbt = (float(np.floor(tbt_budget / bq) * bq)
               if bq > 0 and np.isfinite(tbt_budget) else float(tbt_budget))
        if tq > 0:
            toks = np.ceil(toks / tq) * tq
        md = self.table.cost.mean_decode if mean_decode is None \
            else mean_decode
        decode_present = active_slots > 0 or md > 0
        return self._cached(
            (rem.tobytes(), toks.tobytes(), lam_q, iw, tbt,
             decode_present, drag_steps, md),
            lambda: self.table.solve(
                rem, toks, lam_q, initial_wait=iw, tbt_budget=tbt,
                active_slots=1 if decode_present else 0,
                mean_decode=md, drag_steps=drag_steps))
