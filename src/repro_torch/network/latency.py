"""Communication latency: payload size over the instantaneous bandwidth
plus a small RTT.  Copy of ``repro.network.latency``."""
from __future__ import annotations

import numpy as np

from repro_torch.network.traces import BandwidthTrace


def comm_latency(size_kb: float, trace: BandwidthTrace, now: float,
                 rtt_s: float = 0.02) -> float:
    bw_mbps = trace.at(now)                  # MB/s
    return rtt_s + (size_kb / 1024.0) / max(bw_mbps, 1e-6)


def comm_latency_many(size_kb: np.ndarray, trace: BandwidthTrace,
                      times: np.ndarray, rtt_s: float = 0.02) -> np.ndarray:
    """Vectorized ``comm_latency``: one numpy pass over a whole arrival
    array (element-for-element identical to the scalar model)."""
    bw = np.maximum(trace.at_many(times), 1e-6)
    return rtt_s + (np.asarray(size_kb, np.float64) / 1024.0) / bw
