"""Sponge performance model (paper Eq. 1): the ``PerfModel`` surface.

Copy of ``repro.core.perf_model.PerfModel`` cut to its evaluation
surface (``latency`` / ``throughput``), the contract the slot-pool
backends and ``VerticalScaledInstance`` are typed against (the token
path hands them a ``TokenCostModel``, which has the same surface):

    l(b, c) = γ·b/c + ε/c + δ·b + η
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PerfModel:
    gamma: float   # b/c coefficient
    eps: float     # 1/c coefficient
    delta: float   # b coefficient
    eta: float     # constant
    r2: float = float("nan")
    rmse: float = float("nan")

    def latency(self, b, c):
        b = np.asarray(b, np.float64)
        c = np.asarray(c, np.float64)
        return self.gamma * b / c + self.eps / c + self.delta * b + self.eta

    def throughput(self, b, c):
        return np.asarray(b, np.float64) / np.maximum(self.latency(b, c), 1e-12)
