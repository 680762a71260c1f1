"""Live serving engine: a thin construction shim over the serving API.

.. deprecated::
    New code should construct through
    ``repro_torch.serving.api.make_live_server`` (or compose
    ``SpongeServer`` with a ``TorchBackend`` directly); ``ServingEngine``
    keeps the reference's constructor over a prebuilt step-fn table.

Copy of ``repro.serving.engine``: ``ScenarioRunner`` drives a
``TorchBackend`` holding the executable table built at deploy time --
one entry per (c, b) bucket -- so applying a Decision is an O(1)
dictionary flip (the in-place vertical scaling mechanism).  On one
device every c entry runs the same computation, so vertical scaling
affects scheduling only.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Sequence

from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.slo import Decision, Request
from repro_torch.serving.api import (ScenarioRunner, ServedRequest,
                                     TorchBackend, build_llm_step_fns,
                                     pad_tokens)

warnings.warn(
    "repro_torch.serving.engine is deprecated: construct through "
    "repro_torch.serving.api.make_live_server (or compose SpongeServer "
    "with a TorchBackend)",
    DeprecationWarning, stacklevel=2)

__all__ = ["ServingEngine", "ServedRequest", "build_llm_step_fns",
           "pad_tokens"]


class ServingEngine:
    """Single-instance live engine with in-place vertical scaling.

    Deprecated shim -- prefer ``repro_torch.serving.api.make_live_server``.
    Queue, monitor and dispatch all run inside ``ScenarioRunner``; the
    scaler itself is the SchedulingPolicy (it conforms to the protocol).
    """

    def __init__(self, step_fns: Dict[tuple[int, int], Callable],
                 scaler: SpongeScaler, pad_payload: Callable,
                 prior_rps: float = 0.0):
        """step_fns[(c, b)](stacked_payload) -> batched result (warmed
        before serving).  pad_payload(list_of_payloads, b) -> stacked
        input of bucket size b."""
        self.backend = TorchBackend(step_fns, pad_payload, scaler.perf,
                                    clock="measured")
        self.scaler = scaler
        self.runner = ScenarioRunner(scaler, self.backend,
                                     tick=scaler.adaptation_interval)
        self.runner.monitor.rate.prior_rps = prior_rps
        self.c_set = self.backend.c_set
        self.b_set = self.backend.b_set

    @property
    def monitor(self):
        return self.runner.monitor

    @property
    def queue(self):
        return self.runner.queue

    @property
    def results(self) -> List[ServedRequest]:
        return self.backend.results

    @property
    def decision_log(self) -> List[tuple[float, Decision]]:
        return self.scaler.decisions

    @property
    def c(self) -> int:
        return self.backend.pool[0].instance.c

    @property
    def b(self) -> int:
        return self.runner.b

    def warmup(self, example_payload) -> None:
        self.backend.warmup(example_payload)

    def apply(self, d: Decision, now: float) -> None:
        """Apply a decision out-of-band.  c rounds to the smallest
        available entry >= d.c (never below the solver's feasible c),
        falling back to max(c_set) -- see ``api.round_up_c``."""
        self.runner.apply_decision(d, now)

    def run_script(self, arrivals: Sequence[tuple[Request, object]]
                   ) -> dict:
        """Serves a timed request script in virtual time (event-driven;
        arrivals fire at their scripted times, execution advances the
        clock by the measured batch latency)."""
        report = self.runner.run(list(arrivals))
        mon = self.runner.monitor
        return {
            "n": mon.n_total,
            "violations": mon.n_violations,
            "violation_rate": mon.violation_rate,
            "p50": mon.p(0.5), "p99": mon.p(0.99),
            "decisions": len(self.decision_log),
            "report": report,
        }
