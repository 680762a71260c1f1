"""Workloads: ``WorkloadGenerator``, ``RequestBatch`` and token lengths.

Copy of ``repro.serving.workload`` cut to ``WorkloadGenerator`` (the
fixed-work arrival model over a bandwidth trace: a fixed rate or
seeded Poisson gaps, a payload size with optional seeded jitter, comm
latency from the trace; ``generate`` gives ``Request`` objects,
``generate_batch`` the same workload as a ``RequestBatch``),
``RequestBatch`` (a workload as arrival-sorted numpy columns, the fast
engines' input) and ``lognormal_lengths``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.slo import Request
from repro_torch.network.latency import comm_latency_many
from repro_torch.network.traces import BandwidthTrace


@dataclass(frozen=True)
class RequestBatch:
    """A workload as parallel numpy columns, sorted by ``arrival``.

    Fields mirror ``repro_torch.core.slo.Request``: ``send`` is the client send
    time, ``arrival = send + comm_latency`` the server-side arrival, and
    ``deadline = arrival - cl + slo`` the absolute EDF deadline
    (computed with the same float expression ``Request.make`` uses, so a
    materialized batch is bit-identical to per-request construction).

    Token columns: ``prompt_tokens`` to prefill, ``decode_tokens`` to stream after the
    first token, ``tbt_slo`` the per-token deadline.  For token-shaped
    requests ``deadline`` is the TTFT deadline.  The columns default to
    the fixed-work shape (1/0/inf), so every pre-token consumer of a
    batch is unchanged.

    ``decode_dist`` optionally carries the workload's declared
    decode-length distribution (``core.uncertainty.LengthDistribution``,
    one object for the batch, not a column).  ``decode_tokens`` stays
    the realized ground truth the engines serve; the distribution is
    what the *scheduler* is allowed to know.
    """
    send: np.ndarray
    arrival: np.ndarray
    comm_latency: np.ndarray
    slo: np.ndarray
    deadline: np.ndarray
    size_kb: np.ndarray
    prompt_tokens: Optional[np.ndarray] = None
    decode_tokens: Optional[np.ndarray] = None
    tbt_slo: Optional[np.ndarray] = None
    decode_dist: Optional[object] = None

    def __post_init__(self):
        n = self.arrival.size
        if self.prompt_tokens is None:
            object.__setattr__(self, "prompt_tokens",
                               np.ones(n, np.int64))
        if self.decode_tokens is None:
            object.__setattr__(self, "decode_tokens",
                               np.zeros(n, np.int64))
        if self.tbt_slo is None:
            object.__setattr__(self, "tbt_slo",
                               np.full(n, np.inf, np.float64))

    @classmethod
    def from_send(cls, send: np.ndarray, comm_latency: np.ndarray,
                  slo, size_kb=200.0, prompt_tokens=None,
                  decode_tokens=None, tbt_slo=None,
                  decode_dist=None) -> "RequestBatch":
        """Build + arrival-sort a batch from send times and comm latencies
        (``slo`` / ``size_kb`` / the token columns may be scalars or
        per-request arrays; token columns default to fixed work)."""
        send = np.asarray(send, np.float64)
        cl = np.asarray(comm_latency, np.float64)
        slo = np.broadcast_to(np.asarray(slo, np.float64), send.shape)
        size_kb = np.broadcast_to(np.asarray(size_kb, np.float64),
                                  send.shape)
        arrival = send + cl
        order = np.argsort(arrival, kind="stable")

        def col(x, dtype, default):
            if x is None:
                return np.full(send.shape, default, dtype)[order].copy()
            return np.broadcast_to(np.asarray(x, dtype),
                                   send.shape)[order].copy()

        pt = col(prompt_tokens, np.int64, 1)
        dt = col(decode_tokens, np.int64, 0)
        tbt = col(tbt_slo, np.float64, np.inf)
        send, cl = send[order], cl[order]
        slo, size_kb = slo[order].copy(), size_kb[order].copy()
        arrival = arrival[order]
        return cls(send=send, arrival=arrival, comm_latency=cl, slo=slo,
                   deadline=arrival - cl + slo, size_kb=size_kb,
                   prompt_tokens=pt, decode_tokens=dt, tbt_slo=tbt,
                   decode_dist=decode_dist)

    def __len__(self) -> int:
        return int(self.arrival.size)

    def head(self, k: int) -> "RequestBatch":
        """The first ``k`` arrivals — a true prefix of the scenario (used
        to benchmark baseline runners on a slice of the same workload)."""
        return RequestBatch(send=self.send[:k], arrival=self.arrival[:k],
                            comm_latency=self.comm_latency[:k],
                            slo=self.slo[:k], deadline=self.deadline[:k],
                            size_kb=self.size_kb[:k],
                            prompt_tokens=self.prompt_tokens[:k],
                            decode_tokens=self.decode_tokens[:k],
                            tbt_slo=self.tbt_slo[:k],
                            decode_dist=self.decode_dist)

    def to_requests(self) -> List[Request]:
        """Materialize ``Request`` objects (arrival order) for the exact
        event loop — only sensible at small scale."""
        return [Request(deadline=float(d), arrival=float(a),
                        comm_latency=float(c), slo=float(s),
                        size_kb=float(k), prompt_tokens=int(pt),
                        decode_tokens=int(dt), tbt_slo=float(tb),
                        decode_dist=self.decode_dist)
                for d, a, c, s, k, pt, dt, tb in zip(
                    self.deadline, self.arrival, self.comm_latency,
                    self.slo, self.size_kb, self.prompt_tokens,
                    self.decode_tokens, self.tbt_slo)]


@dataclass
class WorkloadGenerator:
    rps: float = 20.0
    slo: float = 1.0
    size_kb: float = 200.0
    poisson: bool = False
    size_jitter: float = 0.0           # +- fraction of size_kb
    seed: int = 0

    def _columns(self, trace: BandwidthTrace,
                 duration_s: Optional[float] = None):
        """Vectorized arrival model: (send, comm_latency, size) arrays."""
        dur = duration_s or trace.duration
        rng = np.random.default_rng(self.seed)
        if self.poisson:
            n_est = int(self.rps * dur * 1.5) + 10
            gaps = rng.exponential(1.0 / self.rps, size=n_est)
            send_times = np.cumsum(gaps)
            send_times = send_times[send_times < dur]
        else:
            send_times = np.arange(0, dur, 1.0 / self.rps)
        sizes = np.full(send_times.shape, self.size_kb, np.float64)
        if self.size_jitter:
            sizes = self.size_kb * (1.0 + rng.uniform(
                -self.size_jitter, self.size_jitter, size=len(send_times)))
        cl = comm_latency_many(sizes, trace, send_times)
        return send_times, cl, sizes

    def generate(self, trace: BandwidthTrace,
                 duration_s: Optional[float] = None) -> List[Request]:
        """Request objects in send order (the historical surface)."""
        send, cl, sizes = self._columns(trace, duration_s)
        return [Request.make(arrival=float(ts + c), comm_latency=float(c),
                             slo=self.slo, size_kb=float(k))
                for ts, c, k in zip(send, cl, sizes)]

    def generate_batch(self, trace: BandwidthTrace,
                       duration_s: Optional[float] = None) -> RequestBatch:
        """The same workload as an arrival-sorted ``RequestBatch``."""
        send, cl, sizes = self._columns(trace, duration_s)
        return RequestBatch.from_send(send, cl, slo=self.slo, size_kb=sizes)


def lognormal_lengths(rng: np.random.Generator, n: int, median: float,
                      sigma: float, lo: int, hi: int) -> np.ndarray:
    """Bounded log-normal token lengths (int64) — the standard shape of
    LLM prompt/response length distributions.  ``median`` is the
    distribution median (exp(μ)); samples are clipped to [lo, hi]."""
    x = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(np.round(x), lo, hi).astype(np.int64)
