"""Bandwidth traces (paper Fig. 1).

Copy of ``repro.network.traces``: ``BandwidthTrace``, ``synth_4g_trace``
(log-space Ornstein-Uhlenbeck bandwidth with regime shifts and deep
fades, drawn from a seeded generator), ``synth_5g_trace`` (the same
process on a faster, blockage-prone envelope) and ``load_csv_trace``
(a recorded log).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BandwidthTrace:
    t: np.ndarray        # seconds, 1 Hz
    mbps: np.ndarray     # MB/s (megaBYTES, as in the paper's figure)

    def at(self, now: float) -> float:
        i = min(int(now), len(self.mbps) - 1)
        return float(self.mbps[max(i, 0)])

    def at_many(self, times: np.ndarray) -> np.ndarray:
        """Vectorized ``at``: bandwidth sample for every entry of ``times``
        (same truncate-and-clamp indexing as the scalar path)."""
        idx = np.clip(np.asarray(times, np.float64).astype(np.int64),
                      0, len(self.mbps) - 1)
        return self.mbps[idx]

    @property
    def duration(self) -> float:
        return float(self.t[-1])


def synth_4g_trace(duration_s: int = 600, seed: int = 0,
                   lo: float = 0.5, hi: float = 7.0,
                   fade_depth: tuple = (0.15, 0.3)) -> BandwidthTrace:
    """Log-space Ornstein–Uhlenbeck bandwidth with regime shifts and fades.

    Regime-shift and fade counts scale with the duration, so hour-long
    scenario traces keep the paper's per-10-minute mobility statistics
    (short traces draw the same RNG stream as before).
    """
    rng = np.random.default_rng(seed)
    n = int(duration_s)
    x = np.zeros(n)
    mu = np.log(2.5)
    x[0] = mu
    theta, sigma = 0.05, 0.25
    # regime shifts every ~60-120 s (user mobility)
    n_regimes = max(20, n // 90 + 1)
    shift_times = np.cumsum(rng.integers(45, 150, size=n_regimes))
    shifts = {int(t): rng.uniform(np.log(lo * 1.6), np.log(hi * 0.8))
              for t in shift_times if t < n}
    for i in range(1, n):
        if i in shifts:
            mu = shifts[i]
        x[i] = x[i - 1] + theta * (mu - x[i - 1]) + sigma * rng.normal()
    bw = np.exp(x)
    # deep fades (handover/obstruction): a few seconds near the floor
    if n > 20:
        n_fades = int(rng.integers(2, 5)) if n <= 1200 else n // 250
        for _ in range(n_fades):
            s = rng.integers(0, n - 15)
            bw[s:s + rng.integers(4, 12)] *= rng.uniform(*fade_depth)
    bw = np.clip(bw, lo, hi)
    return BandwidthTrace(t=np.arange(n, dtype=np.float64), mbps=bw)


def synth_5g_trace(duration_s: int = 600, seed: int = 0,
                   lo: float = 1.5, hi: float = 40.0) -> BandwidthTrace:
    """5G-class synthetic trace: an order of magnitude more bandwidth than
    the 4G envelope but with mmWave-style blockage — fades are rarer yet
    proportionally deeper, so the *dynamic-SLO* effect (budgets collapsing
    when the link dips) survives even on the faster network."""
    return synth_4g_trace(duration_s, seed=seed, lo=lo, hi=hi,
                          fade_depth=(0.05, 0.15))


def load_csv_trace(path: str, col: int = 1, scale_to_mbytes: float = 1e-6
                   ) -> BandwidthTrace:
    """Load a real 4G log (one sample/line, bytes/s by default)."""
    raw = np.loadtxt(path, delimiter=",", usecols=[col])
    mbps = raw * scale_to_mbytes
    return BandwidthTrace(t=np.arange(len(mbps), dtype=np.float64), mbps=mbps)
