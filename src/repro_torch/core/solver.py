"""The Sponge optimizer: Integer Program (paper Eq. 3) + Algorithm 1.

    minimize   c + delta_pen * b
    s.t.       l(b,c) + q_r(b,c) + cl_max <= SLO   for every request r
               h(b,c) >= lambda
               b, c in Z+

Copy of ``repro.core.solver`` cut to the fixed-work solvers
(``solve_bruteforce``, the paper's Algorithm 1 with the reference's
``initial_wait`` term and damage-minimizing fallback; ``solve_pruned``;
``SolverTable`` behind a ``MemoizedSolver``) and the token solvers
(``solve_token_bruteforce``, ``TokenSolverTable`` behind a
``TokenMemoizedSolver``), with the quantize-and-cache shell they share.
Algorithm 1 iterates c ascending then b ascending and returns the first
feasible (c, b): the lexicographic IP optimum.  The float expressions
and their summation order are the reference's term for term, so both
packages make the same decisions.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import CostModel, TokenCostModel
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.slo import Decision

DEFAULT_C = tuple(range(1, 17))
DEFAULT_B = tuple(range(1, 17))


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
    """The conservative quantize-and-cache shell of the memoized
    solvers (fixed-work and token).

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
