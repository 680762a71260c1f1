"""Op-log analysis: collective-traffic accounting for the roofline.

Counterpart of ``repro.utils.hlo_analysis``.  The port has no HLO: its
record of a step is the op log that ``utils.op_cost.CostMode`` keeps,
one ``OpRecord`` per ATen op a rank ran, its local shards' shapes in
it.  So the totals are per-rank bytes moved over the links, on the
reference's receive-side convention: the result size of each
collective (for all-reduce the ring cost is ~2x(n-1)/n of that; the raw
result bytes are reported and the convention kept fixed, so deltas are
comparable).  A collective is one of the ``_c10d_functional`` ops that
DTensor redistributions and the per-rank bodies' functional
collectives issue; ``COLLECTIVES`` names each by the reference's HLO
kind.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

# the reference's HLO dtype names, bytes per element
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

# torch dtype -> the reference's name
TORCH_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

# ``_c10d_functional`` op name -> the reference's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def tensor_bytes(t) -> int:
    """Bytes of one tensor (its shape times its dtype's width)."""
    return t.numel() * _DTYPE_BYTES[TORCH_DTYPE_NAMES[t.dtype]]


def shape_bytes(shape, dtype: str) -> int:
    """Bytes of a shape of the reference's dtype name ``dtype``."""
    n = 1
    for d in shape:
        n *= d
    return n * _DTYPE_BYTES[dtype]


@dataclass
class OpRecord:
    """One op a rank ran: its ATen name, FLOPs, bytes read and written,
    result bytes, and its collective kind (None for a local op)."""
    op: str
    flops: float = 0.0
    bytes: float = 0.0
    out_bytes: int = 0
    collective: Optional[str] = None


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> str:
        parts = [f"{k}: n={self.count_by_kind[k]} "
                 f"bytes={self.bytes_by_kind[k]:,}"
                 for k in sorted(self.bytes_by_kind)]
        return "; ".join(parts) if parts else "none"


def collective_stats(log) -> CollectiveStats:
    """Result bytes and counts of the collectives of an op log."""
    bytes_by = defaultdict(int)
    count_by = defaultdict(int)
    for rec in log:
        if rec.collective is None:
            continue
        bytes_by[rec.collective] += rec.out_bytes
        count_by[rec.collective] += 1
    return CollectiveStats(dict(bytes_by), dict(count_by))


def duplicate_op_counts(log, top: int = 10) -> list[tuple[str, int]]:
    """Op-name histogram of the products and convolutions -- a cheap
    remat/recompute indicator (the reference counts fusions, dots and
    convolutions; eager has no fusions)."""
    counts: Dict[str, int] = defaultdict(int)
    for rec in log:
        if rec.flops > 0:
            counts[rec.op] += 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]
