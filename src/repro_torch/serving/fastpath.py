"""The struct-of-arrays engines: the control plane on bare arrays.

Copy of ``repro.serving.fastpath``.  ``ScenarioRunner`` is the general
loop: any policy, any backend, live payloads.  At a hundred thousand
requests and more its per-request Python objects (``Request``, monitor
lists, heap tuples) dominate the wall clock.  ``FastSimRunner`` is the
same control plane rebuilt for scale, for the simulated clock only:

* the workload is a ``RequestBatch`` -- one numpy column per field, no
  ``Request`` objects ever exist;
* the EDF queue holds bare ``(deadline, index)`` pairs
  (``core.queueing.FastEDFQueue``) and the solver snapshot is a single
  vectorized sort;
* arrivals and adaptation ticks are streamed; the event heap holds only
  batch completions and per-slot wake-ups (deduplicated), so the heap
  stays O(pool);
* the λ estimator is a two-pointer sliding window over the arrival
  array (``core.monitor.array_window_rate``: the same estimate as
  ``RateEstimator``, including the deploy-prior blend);
* batch latencies come from a table precomputed per ``(c, b)`` -- the
  same floats ``SimBackend.execute`` would produce;
* completions are recorded by fancy-indexed array writes and every
  aggregate in the final ``RunReport`` is one vectorized pass
  (``serving.api.build_array_report``).

The contract, held by ``tests/test_torch_fastpath.py`` against the
verbatim pre-refactor loop in ``serving.reference``, is
decision-for-decision equivalence: same decision sequence, same batch
buckets, same violation count on the same workload.  Policies must speak the bare
``decide(now, queue, lam, initial_wait)`` protocol (Sponge, static, FA2
all do); policies that inspect ``Request`` objects
(``PredictivePolicy``) need the object-based ``ScenarioRunner``.

The event loops themselves live on the online sessions
(``serving.session.FastSession`` / ``TokenFastSession``): this module
keeps the engine configuration, slot pool, decision application and
reporting, while ``run()`` is a thin replay wrapper -- submit the whole
workload, drain, report -- the no-renegotiation special case of the
session.  ``TokenFastSimRunner.scan_engine`` hands the cost model to the
decode-stream scan engine (``serving.scanpath``), which runs on the
card.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.queueing import FastEDFQueue, TokenFastEDFQueue
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.serving.api import RunReport, resolve_decision
from repro_torch.serving.workload import RequestBatch


class _Slot:
    """One servable slot as plain scalars (the fast-path ``Server``)."""
    __slots__ = ("id", "c", "ready_at", "busy_until", "alive_since",
                 "dead_at", "core_seconds", "_last_t")

    def __init__(self, sid: int, c: int, ready_at: float, now: float):
        self.id = sid
        self.c = c
        self.ready_at = ready_at
        self.busy_until = 0.0
        self.alive_since = now
        self.dead_at: Optional[float] = None
        self.core_seconds = 0.0
        self._last_t: Optional[float] = now

    def account(self, now: float) -> None:
        """Integrate allocated core-seconds up to ``now`` (same monotone
        accumulation as ``VerticalScaledInstance.account``).

        Inlined into ``VectorSimRunner._run_ticks_fast`` under a strict
        ``spongelint: inline-of`` marker -- editing this body fails the
        lint until the inlined copy is updated to alpha-match.
        """
        if now > self._last_t:
            self.core_seconds += self.c * (now - self._last_t)
            self._last_t = now


def build_bucket_array(b_set: Sequence[int]) -> np.ndarray:
    """``arr[x]`` = the smallest configured bucket >= x (``bmax`` past
    the end) — the O(1) batch→bucket map shared by every fast engine
    (previously built inline by both this runner and the fleet base)."""
    bmax = b_set[-1]
    buckets = np.empty(bmax + 1, np.int64)
    for x in range(bmax + 1):
        buckets[x] = next((bb for bb in b_set if bb >= x), bmax)
    return buckets


class FastSimRunner:
    """The Sponge control loop over a struct-of-arrays workload.

    Drives any decide-protocol ``SchedulingPolicy`` against simulated
    vertically/horizontally scalable slots, with identical scheduling
    semantics to ``ScenarioRunner`` + ``SimBackend`` (slack-aware EDF
    dispatch, adaptation ticks, resize penalties, cold starts) at a
    fraction of the per-event cost.  See the module docstring for the
    equivalence contract.
    """

    def __init__(self, policy, perf: PerfModel,
                 c_set=DEFAULT_C, b_set=DEFAULT_B, *, c0: int = 1,
                 tick: float = 1.0, resize_penalty: float = 0.005,
                 dispatch_margin: float = 0.02, prior_rps: float = 0.0,
                 rate_window: float = 5.0):
        if not hasattr(policy, "decide"):
            raise TypeError(
                f"{type(policy).__name__} has no decide(); the fast path "
                "drives bare SchedulingPolicy objects only — use "
                "ScenarioRunner for legacy on_tick policies")
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
        # precomputed latency table: identical floats to SimBackend.execute
        self._lat: Dict[tuple[int, int], float] = {
            (c, b): float(perf.latency(b, c))
            for c in self.c_set for b in self.b_set}
        self._bucket_arr = build_bucket_array(self.b_set)
        self._bmax = self.b_set[-1]
        self._sid = itertools.count()
        self.b = 1
        self.queue = FastEDFQueue()
        self.slots: List[_Slot] = [_Slot(next(self._sid), c0, 0.0, 0.0)]
        self.dead: List[_Slot] = []
        self.core_samples: List[tuple[float, int]] = []
        self.bucket_log: List[tuple[float, int, int, int]] = []
        self.events_processed = 0

    # -- helpers -----------------------------------------------------------
    def _bucket(self, b: int) -> int:
        return int(self._bucket_arr[b]) if b <= self._bmax else self._bmax

    @property
    def allocated_cores(self) -> int:
        return sum(s.c for s in self.slots)

    def _apply(self, d, now: float) -> None:
        c, self.b = resolve_decision(self.c_set, d)
        pen = self.resize_penalty
        for s in self.slots:
            s.account(now)
            if s.c != c:
                s.c = c
                if pen:
                    s.busy_until = max(s.busy_until, now) + pen
        n = max(1, getattr(d, "n", 1))
        cur = len(self.slots)
        if n > cur:
            delay = getattr(d, "scale_up_delay", 0.0)
            for _ in range(n - cur):
                self.slots.append(_Slot(next(self._sid), c,
                                        now + delay, now))
        elif n < cur:
            for _ in range(min(cur - n, cur - 1)):
                s = self.slots.pop()
                s.dead_at = max(now, s.busy_until)
                self.dead.append(s)

    # -- entry points ------------------------------------------------------
    def session(self) -> "repro_torch.serving.session.FastSession":
        """Open the online session on this runner (``submit`` /
        ``update_slo`` / ``cancel`` / ``step_until`` — see
        ``repro_torch.serving.session``).  The session owns the event cursor
        and the dispatch pass; one session per runner."""
        from repro_torch.serving.session import FastSession
        return FastSession(self)

    def run(self, batch: RequestBatch,
            horizon: Optional[float] = None) -> RunReport:
        """Thin replay wrapper over :meth:`session`: submit the whole
        (arrival-sorted) workload, drain to ``horizon`` (default: last
        arrival + 60 s) and report.  With no mid-flight events the
        session processes the identical event stream the closed-world
        loop did."""
        sess = self.session()
        sess.submit_batch(batch)
        return sess.finish(horizon)

    def vectorized(self) -> "repro_torch.serving.vectorpath.VectorSimRunner":
        """A fresh :class:`~repro_torch.serving.vectorpath.VectorSimRunner`
        with this runner's exact configuration (policy object included --
        hand over before running either engine).  The vector engine
        replays closed-world workloads bit-identically to :meth:`run`,
        window at a time."""
        from repro_torch.serving.vectorpath import VectorSimRunner
        return VectorSimRunner(
            self.policy, self.perf, self.c_set, self.b_set,
            c0=self.slots[0].c, tick=self.tick,
            resize_penalty=self.resize_penalty,
            dispatch_margin=self.dispatch_margin,
            prior_rps=self.prior_rps, rate_window=self.rate_window)


class TokenFastSimRunner(FastSimRunner):
    """Continuous-batching decode streams on the struct-of-arrays engine.

    The autoregressive extension of :class:`FastSimRunner`:
    the workload is a token-shaped ``RequestBatch`` (``prompt_tokens`` /
    ``decode_tokens`` / ``tbt_slo`` columns) and the single vertically
    scaled instance runs a **decode stream** with true continuous
    batching — between consecutive engine steps, requests *join* the
    running batch (their prompts prefill as part of the next step, first
    token = TTFT at the step boundary) and *leave* it the moment their
    stream completes, with per-slot token counters in plain arrays and
    step latency from the token cost model's composition surface
    (``step_latency(c, (prefill_tokens, decode_slots))``).

    Scheduling semantics:

    * admission is greedy EDF: whenever the running batch has free slots
      (``Decision.b`` is the slot cap) the earliest-deadline waiting
      requests join the next step — continuous batching does not hold
      prompts back to fill buckets;
    * the engine never idles while streams run: the next step starts at
      the previous step's boundary; with no work it sleeps until the
      next arrival;
    * in-place vertical resizes (and their penalty) take effect at the
      next step boundary — a step in flight finishes at the old c;
    * per-token SLOs are checked per step: a running slot's token gap is
      the distance between consecutive step boundaries, so a step longer
      than the slot's ``tbt_slo`` counts one violation for that slot.

    This runner is single-instance (the paper's Sponge mechanism);
    horizontal ``Decision.n`` targets are ignored.  It sustains >=100k
    autoregressive requests per run.
    """

    def __init__(self, policy, cost: TokenCostModel,
                 c_set=DEFAULT_C, b_set=DEFAULT_B, *, c0: int = 1,
                 tick: float = 1.0, resize_penalty: float = 0.005,
                 prior_rps: float = 0.0, rate_window: float = 5.0,
                 uncertainty=None):
        super().__init__(policy, cost, c_set, b_set, c0=c0, tick=tick,
                         resize_penalty=resize_penalty,
                         prior_rps=prior_rps, rate_window=rate_window)
        self.cost = cost
        self.queue = TokenFastEDFQueue()
        self._pending_penalty = 0.0
        # decode-length uncertainty: a non-point
        # ``core.uncertainty.UncertaintyConfig`` arms speculative
        # admission with cancel-on-overrun on the session loop; None or
        # a point mass keeps the deterministic loop verbatim
        self.uncertainty = uncertainty
        self.overrun_cancels = 0   # set by the session at report time

    def _apply(self, d, now: float) -> None:
        """In-place vertical resize; the penalty lands on the next step."""
        c, self.b = resolve_decision(self.c_set, d)
        s = self.slots[0]
        s.account(now)
        if s.c != c:
            s.c = c
            self._pending_penalty += self.resize_penalty

    # -- entry points ------------------------------------------------------
    def session(self) -> "repro_torch.serving.session.TokenFastSession":
        """Open the online session on this runner (TTFT renegotiation /
        cancellation for requests still waiting for admission — see
        ``repro_torch.serving.session``)."""
        from repro_torch.serving.session import TokenFastSession
        return TokenFastSession(self)

    def run(self, batch: RequestBatch,
            horizon: Optional[float] = None) -> RunReport:
        """Thin replay wrapper over :meth:`session` (submit the workload,
        drain, report) — the continuous-batching loop itself lives on
        :class:`~repro_torch.serving.session.TokenFastSession`."""
        sess = self.session()
        sess.submit_batch(batch)
        return sess.finish(horizon)

    def scan_engine(self, *, chunk_steps: int = 64, decide=None
                    ) -> "repro_torch.serving.scanpath.ScanDecodeEngine":
        """A :class:`~repro_torch.serving.scanpath.ScanDecodeEngine`
        built from this runner's cost model and current allocation --
        the decode-stream scan engine, whose chunks run as captured CUDA
        graphs on the card (``backend="torch"``) or as a NumPy loop
        (``backend="numpy"``, the plain version).  Its step semantics
        are a documented simplification of this runner's, not a
        bit-identical replay; the contract is backend parity."""
        from repro_torch.serving.scanpath import ScanDecodeEngine
        return ScanDecodeEngine(self.cost, c0=self.slots[0].c,
                                b0=self.b_set[-1],
                                chunk_steps=chunk_steps, decide=decide)

    # -- reporting ---------------------------------------------------------
    def _token_report(self, batch: RequestBatch, first_tok: np.ndarray,
                      finish: np.ndarray, tbt_bad: np.ndarray,
                      tokens_served: int, decode_tokens_served: int,
                      tbt_viol_tokens: int, horizon: float,
                      n_cancelled: int = 0) -> RunReport:
        """Vectorized aggregates over the token run."""
        served = ~np.isnan(finish)
        send = batch.arrival - batch.comm_latency
        fin = finish[served]
        n_req = int(served.sum())
        ttft_late = first_tok[served] > batch.deadline[served] + 1e-9
        viol = int((ttft_late | tbt_bad[served]).sum())
        e2e = np.sort(fin - send[served])
        ttft = np.sort(first_tok[served] - send[served])
        nn = e2e.size

        def p(a: np.ndarray, q: float) -> float:
            if not a.size:
                return float("nan")
            return float(a[min(int(q * a.size), a.size - 1)])

        core_s = 0.0
        for s in self.slots + self.dead:
            s.account(horizon)
            core_s += s.core_seconds
        decisions = getattr(self.policy, "decisions", None)
        if decisions is None:
            decisions = getattr(getattr(self.policy, "scaler", None),
                                "decisions", None)
        return RunReport(
            policy=getattr(self.policy, "name", type(self.policy).__name__),
            backend="token-sim-fast",
            n_requests=n_req,
            n_violations=viol,
            violation_rate=viol / max(n_req, 1),
            core_seconds=core_s,
            avg_cores=core_s / max(horizon, 1e-9),
            p50=p(e2e, 0.50), p99=p(e2e, 0.99),
            mean_latency=float(e2e.sum()) / max(nn, 1),
            core_timeline=self.core_samples,
            decisions=decisions,
            buckets=self.bucket_log,
            tokens_served=tokens_served,
            tokens_per_s=tokens_served / max(horizon, 1e-9),
            ttft_p50=p(ttft, 0.50), ttft_p99=p(ttft, 0.99),
            tbt_violation_rate=(tbt_viol_tokens
                                / max(decode_tokens_served, 1)),
            n_cancelled=n_cancelled,
        )
