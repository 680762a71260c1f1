"""Baseline autoscalers the paper compares against (§4 "Baseline").

Copy of ``repro.core.baselines``:

* ``FA2Policy`` -- an FA2-style horizontal autoscaler: fixed one-core
  instances, batch chosen for max throughput under the *static* SLO
  (it does not see per-request network latency -- exactly its failure
  mode), reconfiguration every ~10 s, new instances pay a cold start.
* ``StaticPolicy`` -- statically assigned c (8 or 16 cores), dynamic
  batching via the same solver with c pinned.
* ``SpongePolicy`` -- the paper's system: single instance, in-place
  vertical scaling + EDF + dynamic batching via the IP solver.

All of them implement the ``SchedulingPolicy`` protocol
(``repro_torch.serving.api``): ``decide(now, queue, lam, initial_wait)``
returns a ``Decision`` -- with a replica target ``n`` for horizontal
policies -- which the runner applies to whichever backend is plugged
in.  ``Policy.on_tick`` is the runner's entry point.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.queueing import EDFQueue
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.slo import Decision
from repro_torch.core.solver import DEFAULT_B, solve_bruteforce


class Policy:
    """Base scheduling policy: subclasses implement ``decide``; the
    default ``on_tick`` routes through the runner's single drive path."""

    name = "base"

    def due(self, now: float) -> bool:
        return True

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:  # pragma: no cover
        raise NotImplementedError

    def on_tick(self, now: float, sim) -> None:
        sim.drive(self, now)


@dataclass
class SpongePolicy(Policy):
    scaler: SpongeScaler
    name: str = "sponge"

    def due(self, now: float) -> bool:
        return self.scaler.due(now)

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:
        return self.scaler.decide(now, queue, lam,
                                  initial_wait=initial_wait)

    @property
    def decisions(self):
        return self.scaler.decisions


@dataclass
class StaticPolicy(Policy):
    perf: PerfModel
    cores: int = 16
    b_set: Sequence[int] = DEFAULT_B
    interval: float = 1.0
    name: str = "static"
    decisions: List[tuple] = field(default_factory=list)
    _next_t: float = 0.0

    def __post_init__(self):
        self.name = f"static-{self.cores}"

    def due(self, now: float) -> bool:
        return now + 1e-12 >= self._next_t

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:
        self._next_t = now + self.interval
        rem = queue.snapshot_remaining(now)
        d = solve_bruteforce(rem, lam, self.perf, (self.cores,), self.b_set,
                             initial_wait=initial_wait)
        self.decisions.append((now, d))
        return d


@dataclass
class FA2Policy(Policy):
    """Horizontal autoscaling with one-core instances (paper §2.1).

    Chooses b* = argmax_b h(b, 1) s.t. l(b,1) <= slo_budget (FA2 plans with
    the nominal SLO; it cannot see per-request comm latency), targets
    n = ceil(lambda / h(b*, 1)) instances.  Scale-ups pay ``cold_start``
    seconds before the instance serves; reconfiguration happens every
    ``reconfig_interval`` (~10 s to find + adjust + stabilize per the
    paper).  The first decision is the deploy-time warm start (sized to
    ``expected_rps``, no cold start — deployed pre-stabilized, as in the
    paper).
    """
    perf: PerfModel
    slo: float = 1.0
    instance_cores: int = 1
    b_set: Sequence[int] = DEFAULT_B
    reconfig_interval: float = 10.0
    cold_start: float = 10.0
    slo_budget_frac: float = 0.7        # FA2 plans within the NOMINAL SLO (it
                                        # cannot see per-request comm latency)
    max_instances: int = 32
    expected_rps: float = 0.0
    drain_horizon: float = 10.0         # drain backlog within this window
    name: str = "fa2"
    decisions: List[tuple] = field(default_factory=list)
    _next_t: float = 0.0
    _warmed: bool = False

    def best_batch(self) -> int:
        budget = self.slo * self.slo_budget_frac
        best_b, best_h = 1, -1.0
        for b in sorted(self.b_set):
            l = float(self.perf.latency(b, self.instance_cores))
            if l > budget:
                continue
            h = b / l
            if h > best_h:
                best_b, best_h = b, h
        return best_b

    def due(self, now: float) -> bool:
        return (not self._warmed) or now + 1e-12 >= self._next_t

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:
        self._next_t = now + self.reconfig_interval
        b = self.best_batch()
        h = float(self.perf.throughput(b, self.instance_cores))
        if not self._warmed:
            self._warmed = True
            if self.expected_rps > 0:
                n = max(1, math.ceil(self.expected_rps / max(h, 1e-9)))
                d = Decision(c=self.instance_cores, b=b, n=n)
                self.decisions.append((now, d))
                return d
        # backlog-aware target: serve the arrival rate AND drain the queue
        # within the reconfiguration horizon
        lam_eff = lam + len(queue) / self.drain_horizon
        n = max(1, min(self.max_instances,
                       math.ceil(lam_eff / max(h, 1e-9)) if lam_eff > 0
                       else 1))
        d = Decision(c=self.instance_cores, b=b, n=n,
                     scale_up_delay=self.cold_start)
        self.decisions.append((now, d))
        return d
