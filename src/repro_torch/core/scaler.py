"""The Sponge scaler over the token-level cost model.

Copy of ``repro.core.scaler.TokenSpongeScaler`` without the
decode-length ``uncertainty`` option: every adaptation interval, read
the queue's token snapshot and the λ estimate, solve, emit a Decision.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.slo import Decision
from repro_torch.core.solver import (DEFAULT_B, DEFAULT_C,
                                     TokenMemoizedSolver,
                                     solve_token_bruteforce)


@dataclass
class TokenSpongeScaler:
    """The Sponge scaler over the token-level cost model.

    Same control-loop role as the fixed-work Sponge scaler — every adaptation
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

    def decide(self, now: float, queue, lam: float,
               initial_wait: float = 0.0, active_slots: int = 0,
               tbt_budget: Optional[float] = None) -> Decision:
        """One adaptation step: snapshot, solve, log, return."""
        self._next_t = now + self.adaptation_interval
        headroom, drag = self.headroom, self.drag_steps
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
