"""In-place vertical scaling: the executable table keyed by (c, b).

Copy of ``repro.core.vertical`` (``VerticalScaledInstance``,
``TimedExecutor``).  On one device every ``c`` entry shares the same
computation, so a resize changes scheduling only.  ``TimedExecutor``
waits for the device before it reads the clock (``device_sync``):
PyTorch returns from a CUDA call before the card has finished, and a
latency read without the wait would time only the launches.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.perf_model import PerfModel


@dataclass
class ResizeEvent:
    t: float
    c_from: int
    c_to: int
    penalty: float


class VerticalScaledInstance:
    """A single servable model instance with in-place vertical scaling."""

    def __init__(self, c_set: Sequence[int], b_set: Sequence[int],
                 perf: PerfModel, c0: Optional[int] = None,
                 resize_penalty: float = 0.005,
                 weight_bytes: float = 0.0, ici_bw: float = 50e9):
        self.c_set = tuple(sorted(c_set))
        self.b_set = tuple(sorted(b_set))
        self.perf = perf
        self.c = c0 or self.c_set[0]
        assert self.c in self.c_set
        # resize penalty: explicit, or the reference's estimated re-gather
        # time of the weight shard over the TPU interconnect (kept for
        # the API; on one device nothing re-gathers, so callers leave
        # weight_bytes at 0)
        self.resize_penalty = (weight_bytes / ici_bw
                               if weight_bytes else resize_penalty)
        self.resizes: list[ResizeEvent] = []
        self.core_seconds = 0.0
        self._last_t: Optional[float] = None

    # -- the in-place resize (the paper's mechanism) ----------------------
    def resize(self, c: int, now: float = 0.0) -> float:
        """Returns the penalty (seconds) to charge; 0 if no change."""
        assert c in self.c_set, (c, self.c_set)
        self.account(now)
        if c == self.c:
            return 0.0
        self.resizes.append(ResizeEvent(now, self.c, c, self.resize_penalty))
        self.c = c
        return self.resize_penalty

    def account(self, now: float) -> None:
        """Integrate allocated core-seconds up to ``now``."""
        if self._last_t is None:
            self._last_t = now
            return
        if now > self._last_t:
            self.core_seconds += self.c * (now - self._last_t)
            self._last_t = now
        self._last_t = now

    def bucket_b(self, b: int) -> int:
        for bb in self.b_set:
            if bb >= b:
                return bb
        return self.b_set[-1]

    def latency(self, b: int) -> float:
        """Processing latency of a batch of b at the current allocation."""
        return float(self.perf.latency(self.bucket_b(b), self.c))

    def throughput(self) -> float:
        return max(float(self.perf.throughput(b, self.c))
                   for b in self.b_set)


class TimedExecutor:
    """Executable table of ready-to-call step functions keyed by (c, b).

    Measures the wall latency of each call, from the call until the
    device has finished its work (``device_sync``).
    """

    def __init__(self, fns: Dict[tuple[int, int], Callable]):
        self.fns = dict(fns)
        self.calls: list[tuple[float, int, int, float]] = []

    def warmup(self, args_for: Callable[[int, int], tuple]) -> None:
        """Run every distinct step function once before serving (builds
        the kernels and, on the card, captures each entry's CUDA graph).
        Entries that share one function -- every ``c`` of a ``b`` on one
        device -- run once."""
        seen: set[int] = set()
        for (c, b), fn in self.fns.items():
            if id(fn) not in seen:
                seen.add(id(fn))
                fn(*args_for(c, b))
        device_sync()

    def __call__(self, c: int, b: int, *args) -> Any:
        t0 = time.perf_counter()
        out = self.fns[(c, b)](*args)
        device_sync()
        dt = time.perf_counter() - t0
        self.calls.append((t0, c, b, dt))
        return out


def device_sync() -> None:
    """Wait for every queued CUDA kernel (a no-op while no CUDA context
    exists, as in a run on the CPU)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
