"""Operations and bytes of one call of each hand-written kernel, from its
shapes: the least work the call needs (each input read once, each
output written once).  Copied from ``chip_smoke.py`` (``prefill_bound``,
``decode_bound``), with dtypes named by string.
"""
from __future__ import annotations

from perfbench.counts.peaks import ELEMENT_BYTES


def prefill_bound(b, s, h, kv, d, window, dtype="bfloat16"):
    """One causal (sliding-window) prefill: q, k, v read once and out
    written once, against QK^T and PV over the (query, key) pairs the
    mask keeps.  Returns (bytes, operations, dtype of the peak)."""
    elt = ELEMENT_BYTES[dtype]
    nbytes = elt * (2 * b * s * h * d + 2 * b * s * kv * d)
    w = min(window, s)
    # sum over p < s of min(p + 1, w), in closed form
    pairs = w * (w + 1) // 2 + (s - w) * w
    return nbytes, 4.0 * b * h * d * pairs, dtype


def decode_bound(b, s, kv, g, d, lengths, dtype="bfloat16"):
    """One decode call over a cache of s rows: a length L > 0 needs L rows
    of K and V; a length of 0 gives the mean of all s rows of V."""
    elt = ELEMENT_BYTES[dtype]
    row = kv * d * elt
    nbytes = 2 * b * kv * g * d * elt + 4 * b
    flops = 0.0
    for n in lengths:
        nbytes += 2 * n * row if n > 0 else s * row
        flops += 4.0 * kv * g * d * n if n > 0 else 1.0 * kv * g * d * s
    return nbytes, flops, dtype

