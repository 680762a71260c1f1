"""Request / decision dataclasses of the Sponge control plane.

Copy of ``repro.core.slo`` (``Request``, ``Decision``), kept field for
field so a request or decision maps one to one between the packages.
Times are seconds; ``deadline = arrival - comm_latency + slo`` is the
end-to-end budget (paper §3.3), and for token requests the TTFT
deadline.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

_ids = itertools.count()


@dataclass(order=True)
class Request:
    deadline: float                      # absolute; sort key for EDF
    id: int = field(compare=False, default_factory=lambda: next(_ids))
    arrival: float = field(compare=False, default=0.0)   # at server
    comm_latency: float = field(compare=False, default=0.0)
    slo: float = field(compare=False, default=1.0)
    size_kb: float = field(compare=False, default=200.0)
    # token shape (fixed-work defaults: one-shot prefill, no decode)
    prompt_tokens: int = field(compare=False, default=1)
    decode_tokens: int = field(compare=False, default=0)
    tbt_slo: float = field(compare=False, default=float("inf"))
    # the declared distribution of ``decode_tokens``
    # (``core.uncertainty.LengthDistribution``); None or a point mass
    # means the length is known exactly
    decode_dist: Optional[object] = field(compare=False, default=None,
                                          repr=False)
    # lifecycle (filled by the system)
    start_proc: Optional[float] = field(compare=False, default=None)
    first_token: Optional[float] = field(compare=False, default=None)
    finish: Optional[float] = field(compare=False, default=None)
    tbt_violations: int = field(compare=False, default=0)
    # cancel-on-overrun: set by a speculative engine when the stream
    # exhausted its token budget and was cancelled mid-decode (counted
    # in n_cancelled, excluded from latency/violation aggregates)
    cancelled: bool = field(compare=False, default=False)

    @classmethod
    def make(cls, arrival: float, comm_latency: float, slo: float,
             size_kb: float = 200.0, prompt_tokens: int = 1,
             decode_tokens: int = 0,
             tbt_slo: float = float("inf")) -> "Request":
        return cls(deadline=arrival - comm_latency + slo, arrival=arrival,
                   comm_latency=comm_latency, slo=slo, size_kb=size_kb,
                   prompt_tokens=prompt_tokens, decode_tokens=decode_tokens,
                   tbt_slo=tbt_slo)

    def remaining(self, now: float) -> float:
        return self.deadline - now

    @property
    def is_autoregressive(self) -> bool:
        return self.decode_tokens > 0

    @property
    def violated(self) -> bool:
        """Deadline miss: for fixed work the completion deadline; for an
        autoregressive request the TTFT deadline (first token late) or
        any per-token gap beyond ``tbt_slo``."""
        if self.is_autoregressive:
            late_first = (self.first_token is not None
                          and self.first_token > self.deadline + 1e-9)
            return late_first or self.tbt_violations > 0
        return self.finish is not None and self.finish > self.deadline + 1e-9


@dataclass(frozen=True)
class Decision:
    """Scaler output: in-place vertical scale to c, batch size b.

    Horizontal policies (FA2-style, multidimensional scaling) additionally
    set a replica target ``n``; newly added replicas become ready after
    ``scale_up_delay`` seconds (the cold start — only ever paid on the
    horizontal axis).  Vertical-only policies leave both at the defaults.

    Fields:

    * ``c`` — per-replica core count (TPU adaptation: submesh degree);
      backends round *up* to the nearest available entry, never down.
    * ``b`` — batch size the dispatcher fills toward before releasing.
    * ``feasible`` — False when no (c, b) met every deadline and the
      solver fell back to the damage-minimizing drain configuration.
    * ``solver_iters`` / ``solver_time`` — search cost telemetry; a
      memoized-solver cache hit reports the original miss's numbers.
    * ``n`` — replica target (1 for vertical-only policies).
    * ``scale_up_delay`` — seconds before *newly added* replicas serve.
    * ``predicted_tbt`` — token-aware solvers only: the decode-step
      latency the chosen (c, b) is predicted to sustain (b doubles as
      the decode-slot cap on the continuous-batching engines); 0.0 for
      fixed-work decisions.
    * ``m`` — model rung the allocation is planned for (the reference's
      model-ladder solver); ``None`` for single-model decisions.
    """
    c: int
    b: int
    feasible: bool = True
    solver_iters: int = 0
    solver_time: float = 0.0
    n: int = 1
    scale_up_delay: float = 0.0
    predicted_tbt: float = 0.0
    m: Optional[str] = None

    @property
    def cost(self) -> float:
        return float(self.c) * max(self.n, 1)
