"""Sponge performance model (paper Eq. 1-2).

    l(b, c) = (γ/c + δ)·b + ε/c + η  =  γ·b/c + ε/c + δ·b + η
    h(b, c) = b / l(b, c)

Copy of ``repro.core.perf_model``: evaluation, the RANSAC-style robust
fit (the paper cites Fischler-Bolles) over profiled ``(b, c, latency)``
samples, the synthetic generator and the two calibrations the fixed-work
path carries (``yolov5s_like`` for the Fig. 4 study, ``fit_table1`` on
the paper's Table 1).  The float expressions are the reference's term
for term: the solver's decisions depend on them.  The slot-pool
backends and ``VerticalScaledInstance`` are typed against this surface
(the token path hands them a ``TokenCostModel``, which has the same
``latency`` / ``throughput``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class PerfModel:
    gamma: float   # b/c coefficient
    eps: float     # 1/c coefficient
    delta: float   # b coefficient
    eta: float     # constant
    r2: float = float("nan")
    rmse: float = float("nan")

    # ----------------------------------------------------------------- eval
    def latency(self, b, c):
        b = np.asarray(b, np.float64)
        c = np.asarray(c, np.float64)
        return self.gamma * b / c + self.eps / c + self.delta * b + self.eta

    def throughput(self, b, c):
        return np.asarray(b, np.float64) / np.maximum(self.latency(b, c), 1e-12)

    def latency_table(self, bs: Sequence[int], cs: Sequence[int]) -> np.ndarray:
        bb, cc = np.meshgrid(bs, cs, indexing="ij")
        return self.latency(bb, cc)

    # ------------------------------------------------------------------ fit
    @staticmethod
    def _design(b, c):
        b = np.asarray(b, np.float64)
        c = np.asarray(c, np.float64)
        return np.stack([b / c, 1.0 / c, b, np.ones_like(b)], axis=-1)

    @classmethod
    def fit(cls, samples: Iterable[tuple[float, float, float]],
            robust: bool = True, n_iters: int = 200,
            inlier_frac: float = 2.0, seed: int = 0) -> "PerfModel":
        """samples: (b, c, latency_seconds).  RANSAC when robust=True:
        repeatedly fit on minimal subsets, keep the consensus set whose
        residuals are within ``inlier_frac`` x the median residual scale."""
        data = np.asarray(list(samples), np.float64)
        if data.ndim != 2 or data.shape[1] != 3 or len(data) < 4:
            raise ValueError("need >=4 (b, c, latency) samples")
        b, c, y = data.T
        X = cls._design(b, c)

        def lstsq(idx):
            coef, *_ = np.linalg.lstsq(X[idx], y[idx], rcond=None)
            return coef

        best_idx = np.arange(len(y))
        if robust and len(y) >= 8:
            rng = np.random.default_rng(seed)
            best_inliers = -1
            best_scale = np.inf
            for _ in range(n_iters):
                idx = rng.choice(len(y), size=4, replace=False)
                try:
                    coef = lstsq(idx)
                except np.linalg.LinAlgError:
                    continue
                resid = np.abs(X @ coef - y)
                scale = max(np.median(resid), 1e-9)
                inliers = resid <= inlier_frac * scale
                if (inliers.sum(), -scale) > (best_inliers, -best_scale):
                    best_inliers = int(inliers.sum())
                    best_scale = scale
                    best_idx = np.where(inliers)[0]
            # trimmed refinement: refit on the consensus set, re-trim twice
            for _ in range(2):
                coef = lstsq(best_idx)
                resid = np.abs(X @ coef - y)
                scale = max(np.median(resid), 1e-9)
                keep = np.where(resid <= inlier_frac * scale)[0]
                if len(keep) >= 4:
                    best_idx = keep
        coef = lstsq(best_idx)
        pred = X @ coef
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
        rmse = float(np.sqrt(ss_res / len(y)))
        return cls(gamma=float(coef[0]), eps=float(coef[1]),
                   delta=float(coef[2]), eta=float(coef[3]), r2=r2, rmse=rmse)

    # ------------------------------------------------------- synthetic gen
    @classmethod
    def synthetic(cls, gamma=0.040, eps=0.012, delta=0.0008, eta=0.003
                  ) -> "PerfModel":
        """Defaults roughly calibrated to the paper's Table 1 (ResNet human
        detector): l(1,1)=55ms, l(2,1)=97ms, l(4,8)~37ms, l(8,8)~62ms."""
        return cls(gamma=gamma, eps=eps, delta=delta, eta=eta)

    def sample_profile(self, bs, cs, noise: float = 0.02,
                       outlier_frac: float = 0.0, seed: int = 0):
        """Noisy profiling samples drawn from this model (for tests and
        the fit's robustness check)."""
        rng = np.random.default_rng(seed)
        out = []
        for b in bs:
            for c in cs:
                l = float(self.latency(b, c))
                l *= 1.0 + rng.normal(0, noise)
                if outlier_frac and rng.random() < outlier_frac:
                    l *= rng.uniform(2.0, 5.0)
                out.append((float(b), float(c), max(l, 1e-6)))
        return out


def yolov5s_like() -> PerfModel:
    """The reference's YOLOv5s-class model for the Fig. 4 study (a
    synthetic calibration, not a measurement of this package): static-16
    sustains 20 RPS with no violations, static-8 is slightly
    under-provisioned, FA2's one-core instances are per-core efficient
    but have no feasible config when the network budget dips, and Sponge
    floats at ~10-14 cores."""
    return PerfModel(gamma=0.15, eps=0.04, delta=0.032, eta=0.032)


# Paper Table 1 measured points (ResNet human detector, P99 ms):
TABLE1_SAMPLES = [
    # (batch, cores, latency_s)
    (1, 1, 0.055),
    (2, 1, 0.097),
    (4, 2, 0.094),
    (8, 4, 0.092),
    (4, 8, 0.037),
    (8, 8, 0.062),
]


def fit_table1() -> PerfModel:
    return PerfModel.fit(TABLE1_SAMPLES, robust=False)
