"""The work/cost abstraction behind the solvers.

Copy of ``repro.core.cost_model`` cut to what the fixed-work and token
paths use: :class:`Composition` (the work of one engine step), the
:class:`CostModel` protocol, :class:`FixedWorkCostModel` (the paper's
``PerfModel`` as a cost model, decision-identical by construction:
every surface delegates to the wrapped model's own float expression)
and :class:`TokenCostModel` (evaluation, the mixed-step composition
``step_latency`` and the chunked-admission ``prefill_token_allowance``
the continuous-batching engines use, fit, and the synthetic
``smollm_like`` calibration the token scenarios carry).  The float
expressions are the reference's term for term: the solver's decisions
depend on them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Protocol, Union, runtime_checkable

import numpy as np

from repro_torch.core.perf_model import PerfModel


@dataclass(frozen=True)
class Composition:
    """The work of one continuous-batching engine step.

    ``prefill_tokens`` -- total prompt tokens prefilled this step;
    ``decode_slots`` -- running sequences that take one decode step.  A
    fixed-work request batch of size b is ``Composition(prefill_tokens=b,
    decode_slots=0)`` under the one-token-per-request convention of
    :class:`FixedWorkCostModel`.
    """
    prefill_tokens: int
    decode_slots: int


@runtime_checkable
class CostModel(Protocol):
    """What the solver/control-plane layers need from a cost surface.

    ``batch_latency(b, c)`` is the fixed-work view (one dispatch of b
    requests); ``prefill_latency`` / ``decode_latency`` /
    ``step_latency`` expose the token-level decomposition.
    """

    def batch_latency(self, b, c): ...

    def prefill_latency(self, c, tokens): ...

    def decode_latency(self, c, slots): ...

    def step_latency(self, c, comp: Composition) -> float: ...

    def throughput(self, b, c): ...


@dataclass(frozen=True)
class FixedWorkCostModel:
    """The paper's fixed-work model expressed as a :class:`CostModel`.

    One request == a one-shot prefill of exactly one token and an empty
    decode stream, so ``prefill_latency(c, tokens=b)``,
    ``batch_latency(b, c)`` and ``latency(b, c)`` are all the wrapped
    ``perf.latency(b, c)`` -- the same float expression, so every
    decision made through this adapter equals one made on the bare
    ``PerfModel``.
    """
    perf: PerfModel

    def latency(self, b, c):
        """Fixed-work batch latency -- ``perf.latency`` verbatim."""
        return self.perf.latency(b, c)

    def throughput(self, b, c):
        """Fixed-work batch throughput -- ``perf.throughput`` verbatim."""
        return self.perf.throughput(b, c)

    def batch_latency(self, b, c):
        """One dispatch of b requests: ``perf.latency(b, c)`` verbatim."""
        return self.perf.latency(b, c)

    def prefill_latency(self, c, tokens):
        """tokens one-token requests prefilled together: l(tokens, c)."""
        return self.perf.latency(tokens, c)

    def decode_latency(self, c, slots):
        """Fixed work has no decode stream: a decode step is free (and
        the solver's TBT constraint is vacuous)."""
        return np.zeros_like(np.asarray(slots, np.float64)
                             * np.asarray(c, np.float64))

    def step_latency(self, c, comp: Composition) -> float:
        """Pure-prefill step cost; decode slots contribute nothing."""
        if comp.prefill_tokens <= 0:
            return 0.0
        return float(self.perf.latency(comp.prefill_tokens, c))


def as_cost_model(perf_or_cost: Union[PerfModel, CostModel]) -> CostModel:
    """Adapt a ``PerfModel`` to the :class:`CostModel` protocol (wrap it
    in :class:`FixedWorkCostModel`); pass an existing cost model through
    untouched."""
    if isinstance(perf_or_cost, PerfModel):
        return FixedWorkCostModel(perf_or_cost)
    return perf_or_cost


@dataclass(frozen=True)
class TokenCostModel:
    """Affine token-level cost surface with Amdahl scaling in ``c``.

        prefill:  l_p(T, c) = γ_p·T/c + δ_p·T + ε/c + η
        decode:   l_d(S, c) = γ_d·S/c + δ_d·S + ε/c + η
        step:     l(c, (T, S)) = (γ_p·T + γ_d·S + ε)/c + δ_p·T + δ_d·S + η

    T = prefill tokens, S = concurrent decode slots.  γ are the
    parallelizable per-token/per-slot costs, δ the serial ones (the
    GrandSLAm-style linear relation per token instead of per request),
    ε/η the per-step dispatch overheads.  ``mean_prompt`` /
    ``mean_decode`` describe the workload's average request shape and
    back the fixed-work quack surface (``latency``/``throughput``/
    ``batch_latency``): the full-service latency of b mean-shaped
    requests — prefill of ``b·mean_prompt`` tokens plus ``mean_decode``
    decode steps at concurrency b.
    """
    gamma_p: float          # parallel cost per prefill token (s·cores)
    delta_p: float          # serial cost per prefill token (s)
    gamma_d: float          # parallel cost per decode slot-step (s·cores)
    delta_d: float          # serial cost per decode slot-step (s)
    eps: float              # parallel per-step overhead (s·cores)
    eta: float              # serial per-step overhead (s)
    mean_prompt: float = 64.0
    mean_decode: float = 16.0
    r2_prefill: float = float("nan")
    r2_decode: float = float("nan")

    # -- token-level surface ----------------------------------------------
    def prefill_latency(self, c, tokens):
        """Latency of prefilling ``tokens`` prompt tokens at allocation c."""
        t = np.asarray(tokens, np.float64)
        c = np.asarray(c, np.float64)
        return (self.gamma_p * t + self.eps) / c + self.delta_p * t + self.eta

    def decode_latency(self, c, slots):
        """Latency of one decode step over ``slots`` running sequences."""
        s = np.asarray(slots, np.float64)
        c = np.asarray(c, np.float64)
        return (self.gamma_d * s + self.eps) / c + self.delta_d * s + self.eta

    def step_latency(self, c, comp: Composition) -> float:
        """One mixed engine step: admitted prompts + one token per slot.
        Shares a single per-step overhead (ε/c + η)."""
        t, s = float(comp.prefill_tokens), float(comp.decode_slots)
        if t <= 0 and s <= 0:
            return 0.0
        return float((self.gamma_p * t + self.gamma_d * s + self.eps) / c
                     + self.delta_p * t + self.delta_d * s + self.eta)

    # -- fixed-work quack surface (lets baselines plan on token work) -----
    def batch_latency(self, b, c):
        """Full-service latency of b mean-shaped requests: one prefill
        burst of ``b·mean_prompt`` tokens + ``mean_decode`` decode steps
        at concurrency b."""
        b = np.asarray(b, np.float64)
        return (self.prefill_latency(c, b * self.mean_prompt)
                + self.mean_decode * self.decode_latency(c, b))

    def latency(self, b, c):
        """PerfModel-compatible alias of :meth:`batch_latency`."""
        return self.batch_latency(b, c)

    def throughput(self, b, c):
        """Requests/second at full concurrency b (full-service view)."""
        return (np.asarray(b, np.float64)
                / np.maximum(self.batch_latency(b, c), 1e-12))

    def prefill_token_allowance(self, c, slots: int, budget: float) -> float:
        """Max prefill tokens one step can absorb while keeping its
        latency within ``budget`` given ``slots`` running decoders — the
        chunked-admission bound the continuous-batching engine uses to
        keep a large joining prompt from stalling running streams past
        their per-token SLO.  ``inf`` when the budget is infinite."""
        if not np.isfinite(budget):
            return float("inf")
        base = float(self.decode_latency(c, slots))
        per_tok = self.gamma_p / float(c) + self.delta_p
        return (budget - base) / max(per_tok, 1e-12)

    # ------------------------------------------------------------------ fit
    @staticmethod
    def _fit_axis(samples: np.ndarray):
        """Least-squares fit of (x/c, x, 1/c, 1) -> latency.
        samples: rows of (x, c, latency)."""
        x, c, y = samples.T
        X = np.stack([x / c, x, 1.0 / c, np.ones_like(x)], axis=-1)
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        pred = X @ coef
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        return coef, 1.0 - ss_res / max(ss_tot, 1e-12)

    @classmethod
    def fit(cls, prefill_samples: Iterable[tuple[float, float, float]],
            decode_samples: Iterable[tuple[float, float, float]],
            mean_prompt: float = 64.0,
            mean_decode: float = 16.0) -> "TokenCostModel":
        """Fit from profiled samples.

        ``prefill_samples``: rows of (prompt_tokens, c, latency_s);
        ``decode_samples``: rows of (decode_slots, c, latency_s) — e.g.
        from timing the (c, b) prefill/decode step functions
        (``repro_torch.serving.token_backend.calibrate_token_fns``).  The two
        fits share no parameters; ε/η are averaged across the axes so the
        shared per-step overhead stays one number.
        """
        ps = np.asarray(list(prefill_samples), np.float64)
        ds = np.asarray(list(decode_samples), np.float64)
        assert ps.ndim == 2 and ps.shape[1] == 3 and len(ps) >= 4, \
            "need >=4 (tokens, c, latency) prefill samples"
        assert ds.ndim == 2 and ds.shape[1] == 3 and len(ds) >= 4, \
            "need >=4 (slots, c, latency) decode samples"
        (gp, dp, ep, hp), r2p = cls._fit_axis(ps)
        (gd, dd, ed, hd), r2d = cls._fit_axis(ds)
        return cls(gamma_p=float(max(gp, 0.0)), delta_p=float(max(dp, 0.0)),
                   gamma_d=float(max(gd, 0.0)), delta_d=float(max(dd, 0.0)),
                   eps=float(max((ep + ed) / 2.0, 0.0)),
                   eta=float(max((hp + hd) / 2.0, 0.0)),
                   mean_prompt=mean_prompt, mean_decode=mean_decode,
                   r2_prefill=r2p, r2_decode=r2d)

    @classmethod
    def smollm_like(cls, mean_prompt: float = 64.0,
                    mean_decode: float = 24.0) -> "TokenCostModel":
        """The reference's synthetic SmolLM-135M-class coefficients (not a
        measurement of this package): the cost model the token scenarios
        carry in their meta."""
        return cls(gamma_p=2.0e-4, delta_p=2.0e-6,
                   gamma_d=2.5e-3, delta_d=5.0e-5,
                   eps=1.0e-2, eta=2.0e-3,
                   mean_prompt=mean_prompt, mean_decode=mean_decode)
