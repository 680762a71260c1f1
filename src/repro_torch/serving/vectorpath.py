"""The vectorized batched-tick control plane: the third speed tier.

Copy of ``repro.serving.vectorpath``, NumPy only, as the reference.
``FastSimRunner`` (``serving.fastpath``) already strips the object model
down to struct-of-arrays columns, but its event loop still steps one
event at a time in Python: one heap push per arrival, one dispatch
evaluation per event, one λ-pointer increment per request.  At 10M
requests the interpreter is the ceiling.  :class:`VectorSimRunner`
replays the *identical* closed-world event stream window-at-a-time:

* **Vectorized arrival ingestion** — all arrivals inside an
  inter-decision window are admitted with one EDF merge into the sorted
  live set (append-only when the workload's deadline column is globally
  non-decreasing — every mono-SLO scenario — and an argsort +
  ``searchsorted`` + ``insert`` merge otherwise) instead of per-request
  heap pushes.  The merge is exact: new requests carry handles strictly
  larger than every live handle, so inserting at ``side="right"``
  reproduces the heap's ``(deadline, handle)`` pop order bit-for-bit.
  The live set rides in amortized-growth buffers, so the common append
  is two slice writes.
* **Batched dispatch** — between two control events the server either
  drains back-to-back full batches (launch times are the running sum
  ``t, t+l, t+2l, …`` with one fancy-indexed ``finish`` write for the
  whole burst) or sits idle until the *provably next* launch instant —
  the fill arrival that tops the queue up to ``b``, or the slack
  boundary ``head_deadline - latency(c, b) - margin`` that the
  fastpath's wake chain converges to.  Only genuine decision points
  touch Python; everything per-request is an array op.
* **Batched λ updates** — both sliding-window pointers (the observed
  count ``ai`` and the left edge ``w0``) are precomputed for *every*
  adaptation tick with two vectorized ``searchsorted`` calls over the
  whole arrival column before the loop starts; each tick's λ is then
  three scalar flops.  Bit-identical to the per-arrival counter
  (:class:`repro_torch.core.monitor.RateEstimator` /
  :func:`~repro_torch.core.monitor.array_window_rate`) because the canonical
  event order processes every arrival at time ``T`` *before* the tick
  at ``T``, and the tick times themselves are rebuilt with
  ``np.cumsum`` — the same left-fold float chain as ``nt += tick``.
* **Batched decision lookups** — when the policy is the stock
  ``SpongePolicy`` over a memo-solver ``SpongeScaler``, the tick step
  probes the :class:`repro_torch.core.solver.MemoizedSolver` cache directly
  under the solver's own quantized key (the scaler's exact
  headroom/λ-headroom arithmetic followed by ``_quantize``, evaluated
  in preallocated scratch buffers) and replays the scaler's two side
  effects (``_next_t``, the decision log) on a hit — skipping the
  per-tick Python ``decide`` wrapper without changing a single emitted
  Decision (misses fall through to the real ``decide``, which
  populates the same cache under the same key).  Decision application
  is memoized per ``(c, b)`` through the same
  :func:`repro_torch.serving.api.resolve_decision` rule.

Equivalence contract: on every registered closed-world scenario the
decision stream, violation buckets, report floats and core-seconds are
**bit-identical** to ``FastSimRunner`` (the vector engine's tests hold
it, and hold both to the reference's engines).  That holds because
this engine reuses the same ``_apply`` / ``_Slot`` accounting, the same
latency table, the same ``build_array_report`` aggregation, and replays
dispatch decisions at exactly the times the event loop would have made
them (the wake chain ``tw = min(t_force, t + tick)`` always lands on
``t_force`` within a window, because a window is at most one tick
long).

Scope: the closed-world replay path (``run(batch)``) on a **single**
vertically scaled slot — the paper's Sponge mechanism.  Policies that
emit horizontal targets (``Decision.n > 1``, e.g. the FA2 baseline) or
legacy ``on_tick`` mutators are rejected with a pointer to the fast
path; mid-flight session mutation (submit/cancel/update_slo) stays on
``FastSession``.  The three speed tiers: the exact ``ScenarioRunner``
(any policy, any backend), ``FastSimRunner`` (decide-protocol policies,
mid-flight sessions, the fleet) and this engine (closed-world replays of
a single vertically scaled slot).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from repro_torch.core.baselines import SpongePolicy
from repro_torch.core.scaler import SpongeScaler
from repro_torch.serving.api import (RunReport, build_array_report,
                               resolve_decision)
from repro_torch.serving.fastpath import FastSimRunner
from repro_torch.serving.workload import RequestBatch

_INF = float("inf")


# spongelint: inline-of repro_torch.core.monitor.array_window_rate pin=d7ae0c3ba57b
def _lam_at(a: np.ndarray, ai: int, w0: int, now: float,
            window_s: float, prior: float) -> float:
    """:func:`repro_torch.core.monitor.array_window_rate` with the window
    pointers ``(ai, w0)`` precomputed (vectorized ``searchsorted`` over
    the whole tick vector) instead of walked per call — the same
    single-arrival guard and deploy-prior blend, flop for flop."""
    if ai == w0:
        obs = 0.0
    elif ai - w0 == 1:
        obs = 1.0 / window_s
    else:
        span = min(window_s, max(now - a[w0], 1e-6))
        obs = (ai - w0) / span
    if prior <= 0:
        return obs
    seen = max(now - a[0], 0.0) if ai > 0 else 0.0
    w = min(seen / window_s, 1.0)
    return obs * w + prior * (1.0 - w)


class _ArrayEDFView:
    """Read-only EDF queue facade over the runner's sorted live arrays.

    Exposes exactly the surface policies consume (``remaining_array``,
    ``snapshot_remaining``, ``__len__``, ``peek_deadline``).  Because
    the live set is kept sorted by ``(deadline, handle)``,
    ``remaining_array`` is a single vectorized subtraction that matches
    ``FastEDFQueue.remaining_array`` (which sorts its live map) element
    for element."""

    __slots__ = ("_r",)

    def __init__(self, runner: "VectorSimRunner"):
        self._r = runner

    def __len__(self) -> int:
        r = self._r
        return r._qt - r._qh

    def peek_deadline(self) -> Optional[float]:
        r = self._r
        return float(r._q_dl[r._qh]) if r._qt > r._qh else None

    def remaining_array(self, now: float) -> np.ndarray:
        r = self._r
        return r._q_dl[r._qh:r._qt] - now

    def snapshot_remaining(self, now: float) -> List[float]:
        return self.remaining_array(now).tolist()


class VectorSimRunner(FastSimRunner):
    """Window-at-a-time replay of the ``FastSimRunner`` event stream.

    Same constructor, same report, same floats — see the module
    docstring for the equivalence argument.  ``events_processed``
    counts arrivals + adaptation ticks + batch launches (the control
    events the reference loop also pays for; the fastpath's dedup'd
    wake pokes are bookkeeping artifacts and are not counted, which
    only *understates* this engine's events/s)."""

    def run(self, batch: RequestBatch,
            horizon: Optional[float] = None) -> RunReport:
        a = np.asarray(batch.arrival, np.float64)
        n = int(a.size)
        if n and np.any(np.diff(a) < 0):
            raise ValueError("RequestBatch must be sorted by arrival time")
        if n and a[0] < -1e-12:
            raise ValueError("arrival times must be non-negative")
        if horizon is None:
            horizon = (float(a[-1]) + 60.0) if n else 60.0
        if len(self.slots) != 1:
            raise NotImplementedError(
                "vectorpath is single-slot; use FastSimRunner")
        self._acol = a
        self._n_arr = n
        self._dlcol = np.asarray(batch.deadline, np.float64)
        # a globally non-decreasing deadline column (every mono-SLO
        # scenario) turns the EDF merge into a pure append
        self._dl_mono = bool(n < 2 or
                             not np.any(np.diff(self._dlcol) < 0))
        self._hidx = np.arange(n, dtype=np.int64)
        self._finish = np.full(n, np.nan)
        cap = 256
        self._q_dl = np.empty(cap, np.float64)
        self._q_idx = np.empty(cap, np.int64)
        self._qh = 0          # live region is [_qh, _qt)
        self._qt = 0
        # Python-float mirror of the live deadline region [_qh, _qt) —
        # lets the tick loop build its front-cache key with scalar math
        self._q_dll: List[float] = []
        self._p = 0           # arrivals ingested so far (λ pointer too)
        self._now = 0.0
        self._view = _ArrayEDFView(self)
        self._n_batches = 0
        # tick fast path: probe the memo solver's decision cache under
        # its own quantized key (stock SpongePolicy + memo scaler only)
        pol = self.policy
        self._has_due = hasattr(pol, "due")
        self._fast_scaler = self._fast_memo = None
        if type(pol) is SpongePolicy:
            sc = pol.scaler
            if type(sc) is SpongeScaler and sc.solver == "memo":
                self._fast_scaler = sc
                self._fast_memo = sc.memo
        tick = self.tick
        if not tick > 0.0:
            raise ValueError(f"tick must be positive, got {tick!r}")
        # The exact tick chain: the event loop runs `nt += tick` from
        # 0.0 while nt <= horizon.  np.cumsum is the same sequential
        # left-fold addition, so T reproduces every nt bit-for-bit.
        n_up = int(horizon / tick) + 3
        steps = np.full(n_up, tick)
        steps[0] = 0.0
        T = np.cumsum(steps)
        n_ticks = int(T.searchsorted(horizon, side="right"))
        assert n_ticks < n_up, (n_ticks, n_up)
        T = T[:n_ticks]
        # batched λ-window pointers: arrivals observed by each tick
        # (arrivals at T ingest before the tick) and the left window
        # edge — array_window_rate's while-walk, two searchsorted calls
        P = a.searchsorted(T, side="right")
        W0 = a.searchsorted(T - self.rate_window, side="left")
        np.minimum(W0, P, out=W0)   # the walk never passes ai
        if self._fast_scaler is not None:
            self._run_ticks_fast(T.tolist(), P.tolist(), W0.tolist())
        else:
            for nt, pk, wk in zip(T.tolist(), P.tolist(), W0.tolist()):
                self._advance(nt, True, pk)
                self._tick_step(nt, wk, pk)
                self._now = nt
        self._advance(horizon, False,
                      int(a.searchsorted(horizon, side="right")))
        self.events_processed = self._p + n_ticks + self._n_batches
        return build_array_report(self.policy, "sim-vector", batch,
                                  self._finish, horizon,
                                  self.slots + self.dead,
                                  self.core_samples, self.bucket_log)

    # -- control events ----------------------------------------------------
    def _tick_step(self, now: float, w0: int, ai: int) -> None:
        """One adaptation tick for an arbitrary policy: batched λ,
        decide, apply — replicating ``FastSession.drive`` (due-gate,
        tick-granular λ over the whole arrival column, ``initial_wait``
        from the slot's backlog).  The stock Sponge policy takes
        :meth:`_run_ticks_fast` instead."""
        pol = self.policy
        if not self._has_due or pol.due(now):
            lam = _lam_at(self._acol, ai, w0, now,
                          self.rate_window, self.prior_rps)
            wait0 = self.slots[0].busy_until - now
            if wait0 < 0.0:
                wait0 = 0.0
            d = pol.decide(now, self._view, lam, initial_wait=wait0)
            if max(1, getattr(d, "n", 1)) != 1:
                raise NotImplementedError(
                    "vectorpath serves one vertically scaled slot; "
                    "horizontal Decision.n targets need FastSimRunner")
            self._apply(d, now)
            if len(self.slots) != 1:  # pragma: no cover - guarded above
                raise NotImplementedError("vectorpath is single-slot")
        self.core_samples.append((now, self.allocated_cores))

    def _run_ticks_fast(self, Tl: List[float], Pl: List[int],
                        Wl: List[int]) -> None:
        """The whole tick loop for the stock ``SpongePolicy`` over a
        memo-solver ``SpongeScaler``, with every per-tick constant
        hoisted out of the loop:

        * λ from the precomputed window pointers (three scalar flops);
        * the scaler's decide() arithmetic verbatim down to the memo
          solver's ``_quantize``, evaluated in a reused scratch buffer
          (the queue snapshot is already deadline-sorted, so the memo's
          ``np.sort`` would be the identity), then one dict probe; hits
          replay the scaler's two side effects, misses fall through to
          the real ``decide`` which caches under the same key;
        * decision application memoized per ``(d.c, d.b)`` through the
          shared ``resolve_decision`` rule, with the slot's
          core-seconds integrated in place (``_Slot.account``'s exact
          accumulation order).
        """
        sc = self._fast_scaler
        memo = self._fast_memo
        cache = memo.cache
        decs = sc.decisions
        hr = sc.headroom
        lh = sc.lam_headroom
        bq = memo.budget_quantum
        lq = memo.lam_quantum
        ai_step = sc.adaptation_interval
        pen = self.resize_penalty
        pol = self.policy
        s = self.slots[0]
        samples = self.core_samples
        window_s = self.rate_window
        prior = self.prior_rps
        a = self._acol
        a0 = a[0] if self._n_arr else 0.0
        rcache: dict = {}
        # front cache: quantized-state *value* tuple -> Decision.  The
        # scalar key math below is flop-for-flop the ufunc path (same
        # IEEE double ops), so key equality coincides with the memo
        # solver's byte-key equality; a front hit therefore implies a
        # memo hit for the same Decision, and only front misses pay the
        # array round trip that produces the memo's exact byte key.
        front: dict = {}
        scratch = np.empty(1024)
        ceil = math.ceil
        floor = math.floor
        adv = self._advance
        prev = self._now
        for nt, ai, w0 in zip(Tl, Pl, Wl):
            # _advance's busy head-case inline: the slot works past the
            # whole window, so the window is pure bulk ingest
            bu = s.busy_until
            if bu > prev and bu >= nt:
                if ai > self._p:
                    self._ingest(ai)
            else:
                adv(nt, True, ai)
            if nt + 1e-12 >= sc._next_t:        # SpongeScaler.due
                # λ — _lam_at inlined
                # spongelint: inline-of repro_torch.serving.vectorpath._lam_at pin=1dceeb6ce200
                if ai == w0:
                    obs = 0.0
                elif ai - w0 == 1:
                    obs = 1.0 / window_s
                else:
                    span = min(window_s, max(nt - a[w0], 1e-6))
                    obs = (ai - w0) / span
                if prior <= 0:
                    lam = obs
                else:
                    seen = max(nt - a0, 0.0) if ai > 0 else 0.0
                    wgt = min(seen / window_s, 1.0)
                    lam = obs * wgt + prior * (1.0 - wgt)
                wait0 = s.busy_until - nt
                if wait0 < 0.0:
                    wait0 = 0.0
                # the scaler's decide() arithmetic down to the memo
                # solver's _quantize, scalarized:
                # spongelint: inline-of repro_torch.core.scaler.SpongeScaler.decide pin=46b0749bd61b
                # spongelint: inline-of repro_torch.core.solver.MemoizedSolver.solve pin=d56a6198a630
                lam_eff = lam * lh
                lam_q = ceil(lam_eff / lq) * lq if lq > 0 \
                    else float(lam_eff)
                if bq > 0:
                    iw = ceil(wait0 / bq) * bq
                    key = (tuple([
                        floor((0.0 if (x := (dd - nt) - hr) < 0.0
                               else x) / bq) * bq
                        for dd in self._q_dll]), lam_q, iw)
                else:
                    iw = float(wait0)
                    key = (tuple([
                        0.0 if (x := (dd - nt) - hr) < 0.0 else x
                        for dd in self._q_dll]), lam_q, iw)
                d = front.get(key)
                if d is not None:
                    memo.hits += 1
                    sc._next_t = nt + ai_step
                    decs.append((nt, d))
                else:
                    # front miss: the exact array round trip — the memo
                    # solver's own byte key under the scaler's verbatim
                    # arithmetic (queue snapshot already sorted, so the
                    # memo's np.sort would be the identity)
                    qh = self._qh
                    qt = self._qt
                    m = qt - qh
                    if m > scratch.size:
                        scratch = np.empty(max(2 * scratch.size, m))
                    buf = scratch[:m]
                    np.subtract(self._q_dl[qh:qt], nt, out=buf)
                    np.subtract(buf, hr, out=buf)
                    np.maximum(buf, 0.0, out=buf)
                    if bq > 0:
                        np.divide(buf, bq, out=buf)
                        np.floor(buf, out=buf)
                        np.multiply(buf, bq, out=buf)
                    d = cache.get((buf.tobytes(), lam_q, iw))
                    if d is not None:
                        memo.hits += 1
                        sc._next_t = nt + ai_step
                        decs.append((nt, d))
                    else:
                        d = pol.decide(nt, self._view, lam,
                                       initial_wait=wait0)
                    if len(front) >= 200_000:
                        front.clear()
                    front[key] = d
                if max(1, getattr(d, "n", 1)) != 1:
                    raise NotImplementedError(
                        "vectorpath serves one vertically scaled slot; "
                        "horizontal Decision.n targets need FastSimRunner")
                cb = rcache.get((d.c, d.b))
                if cb is None:
                    rcache[(d.c, d.b)] = cb = \
                        resolve_decision(self.c_set, d)
                c, self.b = cb
                if nt > s._last_t:  # spongelint: inline-of repro_torch.serving.fastpath._Slot.account
                    s.core_seconds += s.c * (nt - s._last_t)
                    s._last_t = nt
                # single-slot resize from FastSimRunner._apply:
                # spongelint: inline-of repro_torch.serving.fastpath.FastSimRunner._apply pin=ebcfdaced5a1
                if s.c != c:
                    s.c = c
                    if pen:
                        bu = s.busy_until
                        s.busy_until = (bu if bu > nt else nt) + pen
            samples.append((nt, s.c))
            self._now = prev = nt

    # -- array queue -------------------------------------------------------
    def _grow(self, need: int) -> None:
        """Make room for ``need`` more entries: compact the live region
        to the buffer front, reallocating only when it cannot fit."""
        qh, qt = self._qh, self._qt
        live = qt - qh
        cap = len(self._q_dl)
        if live + need > cap:
            cap = max(2 * cap, live + need + 64)
            nd = np.empty(cap, np.float64)
            ni = np.empty(cap, np.int64)
            nd[:live] = self._q_dl[qh:qt]
            ni[:live] = self._q_idx[qh:qt]
            self._q_dl, self._q_idx = nd, ni
        else:
            self._q_dl[:live] = self._q_dl[qh:qt].copy()
            self._q_idx[:live] = self._q_idx[qh:qt].copy()
        self._qh, self._qt = 0, live

    def _ingest(self, i1: int) -> None:
        """Admit arrivals ``[p, i1)`` with one EDF merge.  New handles
        are strictly larger than every live handle, so a stable argsort
        on deadline plus ``searchsorted(side='right')`` reproduces the
        heap's ``(deadline, handle)`` order exactly.  With a globally
        monotone deadline column the merge is a pure append (two slice
        writes into the live buffers)."""
        p = self._p
        if i1 <= p:
            return
        m = i1 - p
        qh, qt = self._qh, self._qt
        if m == 1:
            # scalar fast path: one arrival is the overwhelmingly common
            # block at sub-second ticks — append in place, or shift-by-
            # one for an interleaved deadline (same (deadline, handle)
            # order np.insert would produce, sans the allocations)
            d0 = self._dlcol[p]
            if self._dl_mono or qt == qh or d0 >= self._q_dl[qt - 1]:
                if qt >= self._q_dl.shape[0]:
                    self._grow(1)
                    qh, qt = self._qh, self._qt
                self._q_dl[qt] = d0
                self._q_idx[qt] = p
                self._qt = qt + 1
                self._q_dll.append(float(d0))
            else:
                if qt >= self._q_dl.shape[0]:
                    self._grow(1)
                    qh, qt = self._qh, self._qt
                pos = qh + int(self._q_dl[qh:qt].searchsorted(
                    d0, side="right"))
                self._q_dl[pos + 1:qt + 1] = self._q_dl[pos:qt].copy()
                self._q_idx[pos + 1:qt + 1] = self._q_idx[pos:qt].copy()
                self._q_dl[pos] = d0
                self._q_idx[pos] = p
                self._qt = qt + 1
                self._q_dll.insert(pos - qh, float(d0))
            self._p = i1
            return
        nd = self._dlcol[p:i1]
        ni = self._hidx[p:i1]
        if not self._dl_mono:
            if m == 2:              # the common small block, sans argsort
                if nd[1] < nd[0]:
                    nd = nd[::-1]
                    ni = ni[::-1]
            elif m > 2:
                order = nd.argsort(kind="stable")
                nd = nd[order]
                ni = ni[order]
            if qt > qh and nd[0] < self._q_dl[qt - 1]:
                # genuine interleave: sorted-merge into fresh buffers
                live_dl = self._q_dl[qh:qt]
                pos = np.searchsorted(live_dl, nd, side="right")
                merged_dl = np.insert(live_dl, pos, nd)
                merged_ix = np.insert(self._q_idx[qh:qt], pos, ni)
                k = merged_dl.size
                cap = max(len(self._q_dl), 2 * k)
                self._q_dl = np.empty(cap, np.float64)
                self._q_idx = np.empty(cap, np.int64)
                self._q_dl[:k] = merged_dl
                self._q_idx[:k] = merged_ix
                self._qh, self._qt = 0, k
                self._q_dll = merged_dl.tolist()
                self._p = i1
                return
        # append path: every new deadline >= the current tail
        if qt + m > len(self._q_dl):
            self._grow(m)
            qt = self._qt
        self._q_dl[qt:qt + m] = nd
        self._q_idx[qt:qt + m] = ni
        self._qt = qt + m
        self._q_dll.extend(nd.tolist())
        self._p = i1

    def _launch(self, t: float, m: int) -> float:
        """Serve the ``m`` earliest-deadline live requests at ``t`` —
        the body of the fastpath's dispatch pop, array-at-a-time."""
        s = self.slots[0]
        qh = self._qh
        bucket = int(self._bucket_arr[m])
        fin = t + self._lat[(s.c, bucket)]
        s.busy_until = fin
        self.bucket_log.append((t, s.c, bucket, m))
        self._finish[self._q_idx[qh:qh + m]] = fin
        self._qh = qh + m
        del self._q_dll[:m]
        self._n_batches += 1
        return fin

    # -- the window engine -------------------------------------------------
    def _advance(self, t_limit: float, open_end: bool, pA: int) -> None:
        """Process every event in the window ending at ``t_limit``.
        ``pA`` is the precomputed arrival bound
        ``searchsorted(arrivals, t_limit, side="right")`` (batched for
        all ticks by ``run``).

        ``open_end=True`` is a tick-bounded window: a completion or
        slack wake at exactly ``t_limit`` loses the tie to the tick and
        is handled by the next window's opening dispatch.  The final
        (horizon-bounded) window is closed: events at exactly the
        horizon are processed.  Arrivals at ``t_limit`` belong to this
        window either way (arrivals precede ticks in the canonical
        order)."""
        a, dlc = self._acol, self._dlcol
        s = self.slots[0]
        t = self._now
        while True:
            fin = s.busy_until
            if fin > t:
                # busy: everything until the completion is bulk ingest
                if fin >= t_limit if open_end else fin > t_limit:
                    if pA > self._p:
                        self._ingest(pA)
                    return
                self._ingest(int(a.searchsorted(fin, side="right")))
                t = fin
            # idle dispatch evaluation at t
            qlen = self._qt - self._qh
            b = self.b
            # t_force must be computed with the event loop's exact float
            # association: (head - l_full) - margin
            l_full = self._lat[(s.c, int(self._bucket_arr[b]))]
            margin = self.dispatch_margin
            if qlen >= b:
                t = self._drain_burst(t, t_limit, open_end, qlen, b)
                continue
            if qlen and t >= self._q_dl[self._qh] - l_full - margin:
                # t stays at the launch time: the loop's busy branch
                # ingests the arrivals that land while the batch runs
                self._launch(t, qlen)
                continue
            # idle scan: walk arrivals one decision at a time until the
            # next launch instant (fill or slack) or the window ends
            head = float(self._q_dl[self._qh]) if qlen else _INF
            p = self._p
            k = 0
            launched = False
            while True:
                nk = p + k
                t_next = a[nk] if nk < pA else _INF
                if qlen + k:
                    tf = head - l_full - margin
                    if tf < t_next:
                        # slack wake fires before the next arrival
                        if tf < t_limit or (not open_end
                                            and tf <= t_limit):
                            self._ingest(nk)
                            self._launch(tf, qlen + k)
                            t = tf
                            launched = True
                        else:
                            self._ingest(pA)  # nk == pA here
                        break
                if nk >= pA:
                    self._ingest(pA)
                    break
                k += 1
                hd = dlc[nk]
                if hd < head:
                    head = float(hd)
                tk = float(a[nk])
                if qlen + k >= b or tk >= head - l_full - margin:
                    # dispatch right after this arrival launches
                    self._ingest(nk + 1)
                    self._launch(tk, min(b, qlen + k))
                    t = tk
                    launched = True
                    break
            if not launched:
                return

    def _drain_burst(self, t: float, t_limit: float, open_end: bool,
                     qlen: int, b: int) -> float:
        """Back-to-back full batches: while the queue holds ``>= b``
        requests and no arrival or window boundary interrupts, launches
        happen at the running-sum times ``t, t+l, t+2l, …`` (the exact
        float chain the event loop produces).  One fancy-indexed write
        finishes the whole burst; only the per-batch log entries touch
        Python."""
        s = self.slots[0]
        c = s.c
        bucket = int(self._bucket_arr[b])
        l = self._lat[(c, bucket)]
        p = self._p
        t_arr = float(self._acol[p]) if p < self._n_arr else _INF
        qh = self._qh
        log = self.bucket_log
        # the opening launch always qualifies: arrivals <= t are already
        # ingested (so t_arr > t) and t is strictly inside the window
        assert t < t_arr and (t < t_limit or (not open_end
                                              and t <= t_limit)), \
            (t, t_limit, open_end, t_arr)
        tj = t + l
        if (qlen < 2 * b or tj >= t_arr
                or (tj >= t_limit if open_end else tj > t_limit)):
            # single full batch — the steady-state common case
            log.append((t, c, bucket, b))
            self._finish[self._q_idx[qh:qh + b]] = tj
            self._qh = qh + b
            del self._q_dll[:b]
            self._n_batches += 1
            s.busy_until = tj
            return t
        times: List[float] = [t]
        kmax = qlen // b
        while len(times) < kmax and tj < t_arr and (
                tj < t_limit or (not open_end and tj <= t_limit)):
            times.append(tj)
            tj += l
        kb = len(times) * b
        self._finish[self._q_idx[qh:qh + kb]] = np.repeat(
            np.array([ti + l for ti in times]), b)
        for ti in times:
            log.append((ti, c, bucket, b))
        self._qh = qh + kb
        del self._q_dll[:kb]
        self._n_batches += len(times)
        s.busy_until = tj
        return times[-1]
