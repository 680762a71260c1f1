"""Predictive scaling, beyond the paper.

Copy of ``repro.core.predictive``.  Sponge is reactive: it sees shrunken
budgets only when requests *arrive* (after the network delay), so the
first adaptation interval of every bandwidth fade is served under a
stale allocation.  ``PredictiveSpongeScaler`` forecasts the near-future
communication latency with damped-trend double exponential smoothing
(Holt) over the observed per-request comm latencies and tightens the
solver's budgets by the predicted *increase*; ``TelemetryPolicy``
instead injects the requests in flight on the gateway's own link as
extra budgets.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.queueing import EDFQueue
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.slo import Decision
from repro_torch.network.latency import comm_latency


class HoltForecaster:
    """Double exponential smoothing with trend damping."""

    def __init__(self, alpha: float = 0.4, beta: float = 0.2,
                 phi: float = 0.9):
        self.alpha, self.beta, self.phi = alpha, beta, phi
        self.level: Optional[float] = None
        self.trend: float = 0.0

    def observe(self, x: float) -> None:
        if self.level is None:
            self.level = x
            return
        prev = self.level
        self.level = (self.alpha * x
                      + (1 - self.alpha) * (self.level + self.phi * self.trend))
        self.trend = (self.beta * (self.level - prev)
                      + (1 - self.beta) * self.phi * self.trend)

    def forecast(self, steps: float = 1.0) -> float:
        if self.level is None:
            return 0.0
        return self.level + self.phi * self.trend * steps


@dataclass
class PredictiveSpongeScaler(SpongeScaler):
    """SpongeScaler + comm-latency forecast folded into the budgets."""
    horizon_s: float = 1.0
    forecaster: HoltForecaster = field(default_factory=HoltForecaster)

    def observe_comm_latency(self, cl: float) -> None:
        self.forecaster.observe(cl)

    def forecast_increase(self) -> float:
        lvl = self.forecaster.level or 0.0
        return max(self.forecaster.forecast(self.horizon_s) - lvl, 0.0)

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:
        saved = self.headroom
        self.headroom = saved + self.forecast_increase()
        try:
            return super().decide(now, queue, lam, initial_wait)
        finally:
            self.headroom = saved


@dataclass
class PredictivePolicy:
    """Policy wrapping the predictive scaler: feeds each observed request's
    comm latency to the forecaster exactly once (in arrival order — the
    signal a real gateway has).  Overrides ``on_tick`` only to feed the
    forecaster before the standard drive path runs."""
    scaler: PredictiveSpongeScaler
    name: str = "sponge-pred"
    _seen: set = field(default_factory=set)

    def _feed(self, sim) -> None:
        # Read the live-entry snapshot, never the raw heap: after a
        # deadline re-key the heap holds stale duplicates (double-feed)
        # and after a cancel it still holds the dead tuple (a request
        # that will never be served polluting the forecast).
        pending = [req for req in sim.queue.live_requests()
                   if req.id not in self._seen]
        done = [r for r in sim.monitor.completed if r.id not in self._seen]
        for r in sorted(pending + done, key=lambda r: r.arrival):
            self.scaler.observe_comm_latency(r.comm_latency)
            self._seen.add(r.id)

    def due(self, now: float) -> bool:
        return self.scaler.due(now)

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:
        return self.scaler.decide(now, queue, lam, initial_wait=initial_wait)

    @property
    def decisions(self):
        return self.scaler.decisions

    def on_tick(self, now: float, sim) -> None:
        self._feed(sim)
        sim.drive(self, now)


@dataclass
class TelemetryPolicy:
    """Bandwidth-telemetry predictive scaling (beyond the paper).

    The serving gateway KNOWS the instantaneous link bandwidth (it is its
    own link).  Requests currently in flight were sent under the *current*
    bandwidth and will arrive with budget ~ SLO - cl(bw_now); during a fade
    that is less than every queued request's budget, so the reactive solver
    under-provisions for one round-trip.  This policy injects the expected
    in-flight requests (count ~ lam * cl_now) as synthetic budget entries.
    """
    scaler: SpongeScaler
    trace: object               # BandwidthTrace
    size_kb: float = 200.0
    slo: float = 1.0
    name: str = "sponge-telem"

    def due(self, now: float) -> bool:
        return self.scaler.due(now)

    def decide(self, now: float, queue: EDFQueue, lam: float,
               initial_wait: float = 0.0) -> Decision:
        cl_now = comm_latency(self.size_kb, self.trace, now)
        n_inflight = int(lam * cl_now)
        extra = tuple(max(self.slo - cl_now, 0.0) + i / max(lam, 1e-6)
                      for i in range(n_inflight))
        return self.scaler.decide(now, queue, lam, initial_wait=initial_wait,
                                  extra_budgets=extra)

    @property
    def decisions(self):
        return self.scaler.decisions

    def on_tick(self, now: float, sim) -> None:
        sim.drive(self, now)
