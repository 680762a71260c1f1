"""The Sponge scalers (paper §3.1 "Scaler"): every adaptation interval,
read the queue snapshot and the λ estimate, solve the IP, and emit a
Decision the engine applies by in-place vertical scaling.

Copy of ``repro.core.scaler``: ``SpongeScaler`` over the fixed-work
``PerfModel`` and ``TokenSpongeScaler`` with the decode-length
``uncertainty`` option.  ``SpongeScaler.solver`` selects the optimizer:

* ``"bruteforce"`` -- the paper's Algorithm 1, a Python double loop
  (the reference semantics);
* ``"pruned"``     -- the vectorized exact variant;
* ``"memo"``       -- a ``MemoizedSolver``: the ``(c, b)`` grid is
  precomputed once and decisions are cached under a quantized
  ``(budgets, λ, wait)`` signature (exact at quanta 0).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import CostModel, TokenCostModel
from repro_torch.core.perf_model import PerfModel
from repro_torch.core.queueing import EDFQueue
from repro_torch.core.slo import Decision
from repro_torch.core.solver import (DEFAULT_B, DEFAULT_C, MemoizedSolver,
                                     TokenMemoizedSolver, solve_bruteforce,
                                     solve_pruned, solve_token_bruteforce)
from repro_torch.core.uncertainty import UncertaintyConfig


@dataclass
class SpongeScaler:
    """Conforms to the ``SchedulingPolicy`` protocol
    (``repro_torch.serving.api``): a bare scaler can be handed to the
    runner directly (the live engine does).

    ``perf`` may be a ``PerfModel`` or any fixed-work-capable
    ``CostModel`` (they share the ``latency(b, c)`` / ``throughput(b, c)``
    surface)."""
    perf: Union[PerfModel, CostModel]
    name: str = "sponge"
    c_set: Sequence[int] = DEFAULT_C
    b_set: Sequence[int] = DEFAULT_B
    adaptation_interval: float = 1.0
    solver: str = "bruteforce"          # bruteforce (paper Alg.1) | pruned | memo
    delta_pen: float = 1e-3
    headroom: float = 0.05              # latency safety margin (seconds)
    lam_headroom: float = 1.05          # provision for lam * this factor
    budget_quantum: float = 0.0         # memo solver: budget bucket (s)
    lam_quantum: float = 0.0            # memo solver: lambda bucket (rps)
    decisions: List[tuple[float, Decision]] = field(default_factory=list)
    _next_t: float = 0.0
    _memo: Optional[MemoizedSolver] = field(default=None, repr=False)

    def due(self, now: float) -> bool:
        return now + 1e-12 >= self._next_t

    @property
    def memo(self) -> MemoizedSolver:
        """The lazily built memoized solver (valid for solver="memo")."""
        if self._memo is None:
            self._memo = MemoizedSolver(
                self.perf, self.c_set, self.b_set,
                budget_quantum=self.budget_quantum,
                lam_quantum=self.lam_quantum)
        return self._memo

    def solver_stats(self) -> dict:
        """Cache economics of the memo solver ({} for exact solvers)."""
        if self._memo is None:
            return {}
        return {"hits": self._memo.hits, "misses": self._memo.misses,
                "hit_rate": self._memo.hit_rate}

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0,
               extra_budgets: tuple = ()) -> Decision:
        """One adaptation step.  ``extra_budgets`` are budgets of
        requests not yet queued (``TelemetryPolicy``'s in-flight
        estimate), solved for beside the queue's."""
        self._next_t = now + self.adaptation_interval
        remaining = np.maximum(queue.remaining_array(now) - self.headroom,
                               0.0)
        if extra_budgets:
            extra = np.maximum(
                np.asarray(extra_budgets, np.float64) - self.headroom, 0.0)
            remaining = np.sort(np.concatenate([remaining, extra]))
        lam_eff = lam * self.lam_headroom
        if self.solver == "memo":
            d = self.memo.solve(remaining, lam_eff,
                                initial_wait=initial_wait)
        else:
            fn = (solve_bruteforce if self.solver == "bruteforce"
                  else solve_pruned)
            d = fn(list(remaining), lam_eff, self.perf, self.c_set,
                   self.b_set, self.delta_pen, initial_wait=initial_wait)
        self.decisions.append((now, d))
        return d


@dataclass
class TokenSpongeScaler:
    """The Sponge scaler over the token-level cost model.

    Same control-loop role as :class:`SpongeScaler` — every adaptation
    interval, read the queue snapshot + λ estimate, solve, emit a
    Decision — but the snapshot is token-aware (per-request TTFT budgets
    + prompt-token counts + the tightest per-token SLO, via
    ``queue.token_snapshot``) and the solve runs the token-composition
    Algorithm 1 (``repro_torch.core.solver.TokenSolverTable`` behind a
    ``TokenMemoizedSolver``; quanta 0 keep it exact).  The Decision's
    ``b`` doubles as the decode-slot cap the continuous-batching engines
    run at; ``predicted_tbt`` carries the solver's sustained decode-step
    latency for telemetry.

    Token-aware runners pass ``active_slots`` (running decode slots) and
    ``tbt_budget`` (tightest per-token budget across queued *and*
    running requests); plain runners may omit both — the scaler then
    derives the TBT bound from the queue alone.
    """
    cost: TokenCostModel
    name: str = "sponge-token"
    c_set: Sequence[int] = DEFAULT_C
    b_set: Sequence[int] = DEFAULT_B
    adaptation_interval: float = 1.0
    solver: str = "memo"                # memo (table+cache) | bruteforce
    headroom: float = 0.05              # TTFT safety margin (seconds)
    tbt_headroom: float = 0.0           # per-token safety margin (seconds)
    lam_headroom: float = 1.05
    budget_quantum: float = 0.0
    lam_quantum: float = 0.0
    token_quantum: int = 0
    # decode-steps of slot-turnover drag per EDF prefill group; None =
    # the cost model's mean decode length (a slot frees when its stream
    # finishes) — see ``repro_torch.core.solver.solve_token_bruteforce``
    drag_steps: Optional[float] = None
    # distribution-aware admission: with a non-point distribution the
    # solve plans drag at the admission quantile and widens the TTFT
    # headroom by the shared predictor's slack factor; None or a point
    # mass leaves the deterministic solve untouched
    uncertainty: Optional[UncertaintyConfig] = None
    decisions: List[tuple[float, Decision]] = field(default_factory=list)
    _next_t: float = 0.0
    _memo: Optional[TokenMemoizedSolver] = field(default=None, repr=False)

    def due(self, now: float) -> bool:
        """Adaptation-interval gate."""
        return now + 1e-12 >= self._next_t

    @property
    def memo(self) -> TokenMemoizedSolver:
        """The lazily built token memoized solver."""
        if self._memo is None:
            self._memo = TokenMemoizedSolver(
                self.cost, self.c_set, self.b_set,
                budget_quantum=self.budget_quantum,
                lam_quantum=self.lam_quantum,
                token_quantum=self.token_quantum)
        return self._memo

    def solver_stats(self) -> dict:
        """Cache economics of the memo solver ({} before first use)."""
        if self._memo is None:
            return {}
        return {"hits": self._memo.hits, "misses": self._memo.misses,
                "hit_rate": self._memo.hit_rate}

    def decide(self, now: float, queue, lam: float,
               initial_wait: float = 0.0, active_slots: int = 0,
               tbt_budget: Optional[float] = None) -> Decision:
        """One adaptation step: snapshot, solve, log, return.

        With a non-point ``UncertaintyConfig`` the p-quantile completion
        estimate gates admission: slot-turnover drag is planned at
        ``dist.quantile(admission_quantile)`` (not the cost model's
        mean) and the TTFT headroom is multiplied by the predictor's
        running slack factor.
        """
        self._next_t = now + self.adaptation_interval
        headroom, drag = self.headroom, self.drag_steps
        unc = self.uncertainty
        if unc is not None and not unc.is_point():
            headroom = self.headroom * unc.predictor.slack_factor()
            drag = unc.drag_estimate()
        rem, toks, queue_tbt = queue.token_snapshot(now)
        remaining = np.maximum(rem - headroom, 0.0)
        tbt = queue_tbt if tbt_budget is None else min(tbt_budget, queue_tbt)
        if np.isfinite(tbt):
            tbt = max(tbt - self.tbt_headroom, 0.0)
        lam_eff = lam * self.lam_headroom
        if self.solver == "bruteforce":
            d = solve_token_bruteforce(
                remaining, toks, lam_eff, self.cost, self.c_set, self.b_set,
                initial_wait=initial_wait, tbt_budget=tbt,
                active_slots=active_slots, drag_steps=drag)
        else:
            d = self.memo.solve(remaining, toks, lam_eff,
                                initial_wait=initial_wait, tbt_budget=tbt,
                                active_slots=active_slots,
                                drag_steps=drag)
        self.decisions.append((now, d))
        return d
