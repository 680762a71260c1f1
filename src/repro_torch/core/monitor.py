"""Monitoring (paper §3.1): arrival-rate estimate and SLO accounting.

Copy of ``repro.core.monitor`` cut to ``RateEstimator`` and ``Monitor``,
the object-path estimators the ``ScenarioRunner`` drives: arrival rate,
completions, drops and cancels, and the perf-model residuals a live
backend records (measured minus predicted batch latency).
"""
from __future__ import annotations

from bisect import insort
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List

from repro_torch.core.slo import Request


class RateEstimator:
    """Sliding-window arrival-rate (lambda) estimate in requests/second.

    ``prior_rps`` is the deployment-time expected rate; it is blended out as
    the observation window fills (prevents the t=0 scale-to-zero artifact —
    the serving analogue of FA2's pre-stabilized start).

    ``retract(t)`` removes one previously observed arrival from the
    window *count* (mid-flight cancellation); the window *span* stays
    anchored at the oldest observed arrival, cancelled or not."""

    def __init__(self, window_s: float = 5.0, prior_rps: float = 0.0):
        self.window_s = window_s
        self.prior_rps = prior_rps
        self._t0: float | None = None
        self._arrivals: Deque[float] = deque()
        self._retracted: List[float] = []    # sorted arrival times

    def observe(self, t: float) -> None:
        if self._t0 is None:
            self._t0 = t
        self._arrivals.append(t)

    def retract(self, t: float) -> None:
        """Retract one observed arrival (the request was cancelled while
        queued) so it stops counting toward the provisioning signal."""
        insort(self._retracted, t)

    def rate(self, now: float) -> float:
        while self._arrivals and self._arrivals[0] < now - self.window_s:
            self._arrivals.popleft()
        lo = now - self.window_s
        if self._retracted:
            k = 0
            while k < len(self._retracted) and self._retracted[k] < lo:
                k += 1
            if k:
                del self._retracted[:k]
        count = len(self._arrivals) - len(self._retracted)
        if count <= 0:
            obs = 0.0
        elif count == 1:
            # single-arrival guard: the observed span collapses to ~0 at
            # the first tick after an idle gap (the lone arrival may sit
            # exactly at ``now``), so count/span would report a huge
            # spurious rate; one arrival in the window is 1/window_s
            obs = 1.0 / self.window_s
        else:
            span = min(self.window_s, max(now - self._arrivals[0], 1e-6))
            obs = count / span
        if self.prior_rps <= 0:
            return obs
        seen = 0.0 if self._t0 is None else max(now - self._t0, 0.0)
        w = min(seen / self.window_s, 1.0)
        return obs * w + self.prior_rps * (1.0 - w)


@dataclass
class Monitor:
    rate: RateEstimator = field(default_factory=RateEstimator)
    completed: List[Request] = field(default_factory=list)
    dropped: List[Request] = field(default_factory=list)
    cancelled: List[Request] = field(default_factory=list)
    perf_residuals: List[float] = field(default_factory=list)

    def observe_arrival(self, req: Request) -> None:
        self.rate.observe(req.arrival)

    def observe_completion(self, req: Request) -> None:
        self.completed.append(req)

    def observe_drop(self, req: Request) -> None:
        self.dropped.append(req)

    def observe_cancel(self, req: Request) -> None:
        """A queued request was cancelled mid-flight: retract its
        arrival from the λ window and exclude it from every served /
        violation aggregate (it is reported separately)."""
        self.cancelled.append(req)
        self.rate.retract(req.arrival)

    def observe_perf_residual(self, predicted: float, measured: float) -> None:
        self.perf_residuals.append(measured - predicted)

    # -- aggregate metrics -------------------------------------------------
    @property
    def n_total(self) -> int:
        return len(self.completed) + len(self.dropped)

    @property
    def n_cancelled(self) -> int:
        return len(self.cancelled)

    @property
    def n_violations(self) -> int:
        return (sum(1 for r in self.completed if r.violated)
                + len(self.dropped))

    @property
    def violation_rate(self) -> float:
        return self.n_violations / max(self.n_total, 1)

    def e2e_latencies(self) -> List[float]:
        return [r.finish - (r.arrival - r.comm_latency)
                for r in self.completed if r.finish is not None]

    def p(self, q: float) -> float:
        ls = sorted(self.e2e_latencies())
        if not ls:
            return float("nan")
        return ls[min(int(q * len(ls)), len(ls) - 1)]
