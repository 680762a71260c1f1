"""Decode-length uncertainty: distributions, quantile admission and the
online length predictor.

Copy of ``repro.core.uncertainty``.  Sponge's IP formulation assumes a
deterministic latency model: every request declares its decode length
and the solver plans slot turnover from the cost model's mean.  Real LLM
traffic does not work like that -- decode lengths are unknown at
admission and heavy-tailed -- so execution time becomes a
*distribution*:

* :class:`LengthDistribution` -- the protocol (``mean`` / ``quantile`` /
  ``cdf`` / ``sample``), with :class:`PointMass`,
  :class:`EmpiricalLengths`, :class:`LognormalLengths` and
  :class:`MixtureLengths` variants.  ``quantile(q)`` is the smallest
  supported length ``v`` with ``cdf(v) >= q``, so ``P(X > quantile(q))
  <= 1 - q``.
* :class:`LengthPredictor` -- an online calibration tracker: the engine
  reports ``(predicted, actual)`` length pairs as streams finish (or
  overrun), and the running calibration error widens or narrows the
  solver's slack multiplicatively (monotonically: more error never
  shrinks slack), blended with a prior error while its window fills.
* :class:`UncertaintyConfig` -- the knobs one run shares between the
  scaler and the engine: the declared distribution, the admission
  quantile (per SLO class via ``class_quantiles``), the speculation
  switch, and the predictor instance (shared so that the engine's
  observations feed the solver's slack).

**Point-mass reduction.**  Whenever ``UncertaintyConfig.is_point()``
holds (no distribution, or ``dist.is_point()``), the scaler and the
token engine take their deterministic code paths verbatim: same solver
inputs, same admission order, same event stream.

Under a real distribution ``TokenSpongeScaler`` plans slot-turnover
drag at ``dist.quantile(admission_quantile)`` and widens its TTFT
headroom by the predictor's slack factor, and ``TokenSimBackend``
admits greedily with a per-stream token budget ``ceil(quantile(q_class)
* margin * slack)``: a stream that exhausts it before finishing is
cancelled at the step boundary (``Monitor.observe_cancel``), counts in
``RunReport.n_cancelled`` and is excluded from every latency and
violation aggregate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np

__all__ = [
    "EmpiricalLengths", "LengthDistribution", "LengthPredictor",
    "LognormalLengths", "MixtureLengths", "PointMass",
    "UncertaintyConfig",
]


@runtime_checkable
class LengthDistribution(Protocol):
    """A distribution over decode lengths (positive integer tokens)."""

    def mean(self) -> float: ...

    def cdf(self, x: float) -> float: ...

    def quantile(self, q: float) -> float: ...

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray: ...

    def is_point(self) -> bool: ...


def _check_q(q: float) -> float:
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    return float(q)


@dataclass(frozen=True)
class PointMass:
    """Degenerate distribution: the length is known exactly.

    Attaching a point mass is *declaring determinism* — every
    uncertainty-aware code path reduces to the deterministic engine
    verbatim (see the module docstring's point-mass reduction).
    """
    value: float

    def mean(self) -> float:
        return float(self.value)

    def cdf(self, x: float) -> float:
        return 1.0 if x >= self.value else 0.0

    def quantile(self, q: float) -> float:
        _check_q(q)
        return float(self.value)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return np.full(n, self.value, np.float64)

    def is_point(self) -> bool:
        return True


@dataclass(frozen=True)
class EmpiricalLengths:
    """The empirical distribution of an observed length sample
    (e.g. yesterday's production decode lengths)."""
    samples: Tuple[float, ...]

    def __post_init__(self):
        if not self.samples:
            raise ValueError("EmpiricalLengths needs at least one sample")
        object.__setattr__(self, "samples",
                           tuple(sorted(float(s) for s in self.samples)))

    @classmethod
    def from_array(cls, a) -> "EmpiricalLengths":
        return cls(tuple(np.asarray(a, np.float64).tolist()))

    def mean(self) -> float:
        return float(sum(self.samples) / len(self.samples))

    def cdf(self, x: float) -> float:
        import bisect
        return bisect.bisect_right(self.samples, x) / len(self.samples)

    def quantile(self, q: float) -> float:
        _check_q(q)
        n = len(self.samples)
        # smallest order statistic with cdf >= q
        k = min(max(int(math.ceil(q * n)), 1), n) - 1
        return float(self.samples[k])

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        idx = rng.integers(0, len(self.samples), size=n)
        return np.asarray(self.samples, np.float64)[idx]

    def is_point(self) -> bool:
        return self.samples[0] == self.samples[-1]


@dataclass(frozen=True)
class LognormalLengths:
    """Bounded log-normal lengths — the same parameterization as the
    workload generator's ``lognormal_lengths`` (``median = exp(mu)``,
    samples rounded and clipped to ``[lo, hi]``), so a scenario can
    declare exactly the distribution it draws from."""
    median: float
    sigma: float
    lo: int = 1
    hi: int = 1 << 20

    def __post_init__(self):
        if self.median <= 0 or self.sigma < 0:
            raise ValueError("median must be > 0 and sigma >= 0")
        if self.lo > self.hi:
            raise ValueError("lo must be <= hi")

    def mean(self) -> float:
        if self.sigma == 0:
            return float(min(max(self.median, self.lo), self.hi))
        # clipped mean via sampling-free moment formula would ignore the
        # clip; integrate the clipped variable over the integer support
        # only when the bounds actually bite, else use the closed form
        m = self.median * math.exp(0.5 * self.sigma ** 2)
        if self.cdf(self.hi - 1) > 0.999 and self.lo <= 1:
            return float(m)
        # coarse but deterministic: expectation over the clipped CDF
        xs = np.arange(self.lo, self.hi + 1, dtype=np.float64)
        if xs.size > 200_000:                      # keep it bounded
            xs = np.linspace(self.lo, self.hi, 200_000)
        cdf = self._cdf_arr(xs)
        pmf = np.diff(np.concatenate([[0.0], cdf]))
        pmf[-1] += 1.0 - cdf[-1]
        return float((xs * pmf).sum())

    def _cdf_arr(self, x: np.ndarray) -> np.ndarray:
        z = (np.log(np.maximum(x + 0.5, 1e-300))
             - math.log(self.median)) / max(self.sigma, 1e-12)
        return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))

    def cdf(self, x: float) -> float:
        # the generator rounds then clips, so mass below lo sits at lo
        # and mass above hi sits at hi
        if x < self.lo:
            return 0.0
        if x >= self.hi:
            return 1.0
        if self.sigma == 0:
            return 1.0 if x >= self.median else 0.0
        z = (math.log(x + 0.5) - math.log(self.median)) / self.sigma
        return 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))

    def quantile(self, q: float) -> float:
        _check_q(q)
        lo, hi = int(self.lo), int(self.hi)
        # integer bisection for the smallest v with cdf(v) >= q — exact
        # under the declared (rounded, clipped) sampling scheme
        while lo < hi:
            mid = (lo + hi) // 2
            if self.cdf(mid) >= q:
                hi = mid
            else:
                lo = mid + 1
        return float(lo)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        x = rng.lognormal(mean=math.log(self.median), sigma=self.sigma,
                          size=n)
        return np.clip(np.round(x), self.lo, self.hi).astype(np.float64)

    def is_point(self) -> bool:
        return self.sigma == 0.0 or self.lo == self.hi


@dataclass(frozen=True)
class MixtureLengths:
    """A finite mixture of length distributions (e.g. short chat
    answers + long retrieval-augmented generations)."""
    components: Tuple[LengthDistribution, ...]
    weights: Tuple[float, ...]

    def __post_init__(self):
        if len(self.components) != len(self.weights) or not self.components:
            raise ValueError("components and weights must align (>= 1)")
        w = tuple(float(x) for x in self.weights)
        if any(x < 0 for x in w) or sum(w) <= 0:
            raise ValueError("weights must be non-negative, sum > 0")
        total = sum(w)
        object.__setattr__(self, "weights", tuple(x / total for x in w))

    def mean(self) -> float:
        return float(sum(w * c.mean()
                         for w, c in zip(self.weights, self.components)))

    def cdf(self, x: float) -> float:
        return float(sum(w * c.cdf(x)
                         for w, c in zip(self.weights, self.components)))

    def quantile(self, q: float) -> float:
        _check_q(q)
        # bisect over the integer support spanned by the components
        lo = int(min(c.quantile(1e-9) if not isinstance(c, PointMass)
                     else c.value for c in self.components))
        hi = int(math.ceil(max(c.quantile(1.0 - 1e-12)
                               if not isinstance(c, PointMass)
                               else c.value for c in self.components)))
        lo = max(lo, 0)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.cdf(mid) >= q:
                hi = mid
            else:
                lo = mid + 1
        return float(lo)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        choice = rng.choice(len(self.components), size=n, p=self.weights)
        out = np.empty(n, np.float64)
        for k, c in enumerate(self.components):
            mask = choice == k
            cnt = int(mask.sum())
            if cnt:
                out[mask] = c.sample(rng, cnt)
        return out

    def is_point(self) -> bool:
        if not all(c.is_point() for c in self.components):
            return False
        vals = {c.quantile(0.5) if not isinstance(c, PointMass)
                else c.value for c in self.components}
        return len(vals) == 1


class LengthPredictor:
    """Online quantile-coverage calibration → solver slack.

    The engine calls :meth:`observe` with the length it *planned for*
    (the admission-quantile estimate), the length the stream
    *realized*, and the tail mass the plan promised (``1 - q``), as
    streams finish or overrun.  If the declared distribution is
    correct, the fraction of streams exceeding the planned quantile
    converges to exactly that tail mass — :meth:`calibration_error` is
    the *excess* overrun fraction (``max(0, observed - promised)``)
    over the last ``window`` observations, blended with
    ``prior_error`` while the window fills (the ``RateEstimator``
    prior idiom — early slack stays wide, sustained good calibration
    narrows it toward 1).  A distribution whose tail is *declared too
    thin* overruns more often than promised, the error grows, and
    :meth:`slack_factor` widens the solver's plans; an over-pessimistic
    declaration clips at zero error rather than shrinking plans below
    the declared quantile.  ``slack_factor`` is clipped to ``[floor,
    cap]`` and **monotone non-decreasing in the error** — the property
    ``tests/test_torch_uncertainty.py`` pins.
    """

    def __init__(self, window: int = 256, gain: float = 4.0,
                 prior_error: float = 0.05, floor: float = 1.0,
                 cap: float = 3.0):
        if window < 1:
            raise ValueError("window must be >= 1")
        if not floor <= cap:
            raise ValueError("floor must be <= cap")
        self.window = int(window)
        self.gain = float(gain)
        self.prior_error = float(prior_error)
        self.floor = float(floor)
        self.cap = float(cap)
        self._dev = np.zeros(self.window, np.float64)
        self._idx = 0
        self._count = 0
        self._sum = 0.0

    def observe(self, predicted: float, actual: float,
                tail: float = 0.1) -> None:
        """Record one (planned, realized, promised-tail) triple — O(1).

        The stored deviation is ``1{actual > predicted} - tail``: its
        window mean is the coverage error of the declared quantile.
        """
        e = (1.0 if float(actual) > float(predicted) else 0.0) - \
            float(tail)
        if self._count >= self.window:
            self._sum -= self._dev[self._idx]
        else:
            self._count += 1
        self._dev[self._idx] = e
        self._sum += e
        self._idx = (self._idx + 1) % self.window

    @property
    def n_observed(self) -> int:
        """Observations recorded so far (window-capped memory)."""
        return self._count

    def calibration_error(self) -> float:
        """Prior-blended excess-overrun fraction of the window
        (``max(0, overrun_fraction - promised_tail)``)."""
        if self._count == 0:
            return self.prior_error
        w = min(self._count / self.window, 1.0)
        recent = max(0.0, self._sum / self._count)
        return (1.0 - w) * self.prior_error + w * recent

    def slack_factor(self) -> float:
        """Multiplicative solver slack: ``clip(1 + gain * error)`` —
        monotone non-decreasing in the calibration error."""
        return min(self.cap,
                   max(self.floor, 1.0 + self.gain * self.calibration_error()))


@dataclass
class UncertaintyConfig:
    """One run's uncertainty knobs, shared by scaler and engine.

    * ``dist`` — the declared decode-length distribution (None or a
      point mass ⇒ the deterministic paths run verbatim).
    * ``admission_quantile`` — the solver plans slot turnover at this
      quantile of ``dist`` (paper-facing knob: admit iff the p-quantile
      completion estimate meets the deadline).
    * ``class_quantiles`` — optional per-SLO-class overrides: sorted
      ``(slo_upper_bound, quantile)`` pairs; a request whose TTFT SLO
      is <= the first matching bound uses that quantile (tight classes
      usually want higher quantiles), everything else the default.
    * ``speculative`` — admit greedily with per-stream token budgets
      and cancel-on-overrun; False runs streams to completion (the
      solver still plans at the quantile).
    * ``overrun_margin`` — budget multiplier on top of the quantile
      estimate (>1 tolerates mild overruns before cancelling).
    * ``predictor`` — the shared :class:`LengthPredictor`; its slack
      factor widens both the solver headroom and the token budgets.
    """
    dist: Optional[LengthDistribution] = None
    admission_quantile: float = 0.9
    class_quantiles: Tuple[Tuple[float, float], ...] = ()
    speculative: bool = True
    overrun_margin: float = 1.0
    predictor: LengthPredictor = field(default_factory=LengthPredictor)
    _qcache: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.dist is not None:
            _check_q(self.admission_quantile)
        for bound, q in self.class_quantiles:
            _check_q(q)
            if bound <= 0:
                raise ValueError(f"SLO class bound must be > 0: {bound}")
        if self.overrun_margin < 1.0:
            raise ValueError("overrun_margin must be >= 1.0")

    def is_point(self) -> bool:
        """True ⇒ every uncertainty path reduces to the deterministic
        engine verbatim (the bit-identity contract)."""
        return self.dist is None or self.dist.is_point()

    def quantile_for(self, slo: float) -> float:
        """Admission quantile for a request's SLO class."""
        for bound, q in sorted(self.class_quantiles):
            if slo <= bound:
                return q
        return self.admission_quantile

    def _q(self, q: float) -> float:
        """Cached ``dist.quantile`` (the distribution is immutable for
        the run; quantiles are hit once per admitted stream)."""
        v = self._qcache.get(q)
        if v is None:
            v = float(self.dist.quantile(q))
            self._qcache[q] = v
        return v

    def planned_length(self, slo: float) -> float:
        """The decode length admission planned for this SLO class —
        what the predictor scores realized lengths against."""
        return self._q(self.quantile_for(slo))

    def observe(self, predicted: float, actual: float,
                slo: float) -> None:
        """Feed one finished/overrun stream to the predictor, scoring
        the realized length against the planned quantile with the tail
        mass that quantile promised for the request's SLO class."""
        self.predictor.observe(predicted, actual,
                               tail=1.0 - self.quantile_for(slo))

    def budget_tokens(self, slo: float) -> int:
        """The per-stream decode-token budget enforced by
        cancel-on-overrun: quantile estimate × margin × slack."""
        return max(1, int(math.ceil(self.planned_length(slo)
                                    * self.overrun_margin
                                    * self.predictor.slack_factor())))

    def drag_estimate(self) -> float:
        """Slot-turnover drag for the solver: the admission-quantile
        length widened by the predictor's slack."""
        return self._q(self.admission_quantile) * \
            self.predictor.slack_factor()

    def stats(self) -> dict:
        """Telemetry snapshot for run stats / benchmarks."""
        return {"quantile": self.admission_quantile,
                "speculative": self.speculative,
                "point": self.is_point(),
                "calibration_error": self.predictor.calibration_error(),
                "slack_factor": self.predictor.slack_factor(),
                "n_observed": self.predictor.n_observed}
