"""The arithmetic the metric readers share: percentiles over all samples,
and each request's latencies on the wall clock.

A request that never got its tokens counts as missing every limit: its
time to first token is infinite, so a percentile that reaches it is
infinite too.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional

INF = math.inf


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) of all the values, interpolated
    linearly between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == INF:
        return INF
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts(run) -> List[float]:
    """Send to first token, for every request sent in the window."""
    return [run.tokens[r.index][0] - r.send if r.index in run.tokens else INF
            for r in run.reqs]


def met(run, r) -> bool:
    """The request's first token came by send + slo, and no gap between
    its tokens exceeded its TBT limit (``Request.violated``'s rule)."""
    ts = run.tokens.get(r.index)
    if ts is None:
        return False
    gaps_ok = all(b - a <= r.tbt_slo + 1e-12 for a, b in zip(ts, ts[1:]))
    return ts[0] <= r.send + r.ttft_slo + 1e-9 and gaps_ok


def attainment_pct(run) -> float:
    return 100.0 * sum(met(run, r) for r in run.reqs) / len(run.reqs)


def gaps_in_window(run) -> List[float]:
    """Every gap between consecutive tokens of a request whose later token
    came inside the window."""
    return [b - a for ts in run.tokens.values() for a, b in zip(ts, ts[1:])
            if b < run.seconds]


def tokens_in_window(run) -> int:
    return sum(1 for ts in run.tokens.values() for t in ts if t < run.seconds)


def window_gangs(run):
    return [g for g in run.gangs if run.in_window(g)]


def traced_gangs(run):
    return [g for g in run.gangs if g.traced]
