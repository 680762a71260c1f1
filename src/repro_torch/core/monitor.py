"""Monitoring (paper §3.1): arrival-rate estimate and SLO accounting.

Copy of ``repro.core.monitor`` cut to the struct-of-arrays λ windows
(``array_window_rate``, ``tick_window_rate`` and
``array_window_rate_cancel_aware``, which the fast engines' column
sessions read) and ``RateEstimator`` and ``Monitor``, the object-path
estimators the ``ScenarioRunner`` drives: arrival rate, completions,
drops and cancels, and the perf-model residuals a live backend records
(measured minus predicted batch latency).  The two estimators give the
same floats: a cancel retracts from the window count and leaves the
span anchored at the oldest observed arrival on both paths.
"""
from __future__ import annotations

from bisect import insort
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List

import numpy as np

from repro_torch.core.slo import Request


def array_window_rate(arr, ai: int, w0: int, now: float,
                      window_s: float, prior_rps: float
                      ) -> tuple[float, int]:
    """:class:`RateEstimator`'s estimate over a bare arrival array — the
    ONE sliding-window λ shared by the struct-of-arrays engines (the
    column sessions of ``serving.session`` resolve through this helper,
    so the estimate cannot drift between engines).

    ``arr`` is the (sorted) arrival-time column, ``ai`` the count of
    arrivals observed so far, ``w0`` the caller-held left window pointer.
    Returns ``(lambda, new_w0)``.  Semantics match ``RateEstimator``
    exactly: the single-arrival guard (a lone arrival at the first tick
    after an idle gap gives a ~zero-length window; dividing by it would
    report a million-rps spike and over-provision) and the deploy-prior
    blend that fades ``prior_rps`` out as the window fills.
    """
    lo = now - window_s
    while w0 < ai and arr[w0] < lo:
        w0 += 1
    if ai == w0:
        obs = 0.0
    elif ai - w0 == 1:
        obs = 1.0 / window_s
    else:
        span = min(window_s, max(now - arr[w0], 1e-6))
        obs = (ai - w0) / span
    if prior_rps <= 0:
        return obs, w0
    seen = max(now - arr[0], 0.0) if ai > 0 else 0.0
    w = min(seen / window_s, 1.0)
    return obs * w + prior_rps * (1.0 - w), w0


def tick_window_rate(arr, w0: int, now: float, window_s: float,
                     prior_rps: float) -> tuple[float, int]:
    """Tick-granular :func:`array_window_rate`: derive the observed-count
    pointer ``ai`` from the arrival column itself instead of having the
    event loop advance a counter per arrival.

    Valid whenever the caller asks for λ only at times by which every
    arrival ``<= now`` has been observed — exactly the adaptation-tick
    contract of every closed-world engine (the canonical event order
    processes arrivals at time T *before* the tick at T), so
    ``ai = searchsorted(arr, now, side="right")`` equals the count the
    per-arrival increment would have reached, and the estimate is
    bit-identical.  ``arr`` must be a sorted numpy array (the workload's
    arrival column).  Returns ``(lambda, new_w0)``.
    """
    ai = int(np.searchsorted(arr, now, side="right"))
    return array_window_rate(arr, ai, w0, now, window_s, prior_rps)


def array_window_rate_cancel_aware(arr, ai: int, w0: int, now: float,
                                   window_s: float, prior_rps: float,
                                   cancels, cw0: int
                                   ) -> tuple[float, int, int]:
    """:func:`array_window_rate` with cancelled arrivals retracted.

    ``cancels`` is a sorted (ascending) sequence of the *arrival times*
    of requests cancelled while queued, ``cw0`` the caller-held left
    pointer into it.  The in-window cancel count is subtracted from the
    in-window arrival count before the rate formula; the span still
    anchors at the oldest in-window arrival (cancelled or not), exactly
    like :meth:`RateEstimator.retract` on the object path, so the two
    estimators stay float-identical.  With no cancels in the window the
    formula collapses to :func:`array_window_rate` bit-for-bit.
    Returns ``(lambda, new_w0, new_cw0)``.
    """
    lo = now - window_s
    while w0 < ai and arr[w0] < lo:
        w0 += 1
    nc = len(cancels)
    while cw0 < nc and cancels[cw0] < lo:
        cw0 += 1
    count = (ai - w0) - (nc - cw0)
    if count <= 0:
        obs = 0.0
    elif count == 1:
        obs = 1.0 / window_s
    else:
        span = min(window_s, max(now - arr[w0], 1e-6))
        obs = count / span
    if prior_rps <= 0:
        return obs, w0, cw0
    seen = max(now - arr[0], 0.0) if ai > 0 else 0.0
    w = min(seen / window_s, 1.0)
    return obs * w + prior_rps * (1.0 - w), w0, cw0


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
