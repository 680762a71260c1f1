"""Per-rank cost of a step, counted op by op.

Counterpart of ``repro.utils.hlo_cost``.  The reference parses the
optimized HLO and weights every ``while`` body by its trip count; the
port runs eager PyTorch, whose Python loops issue every op they run, so
no weighting is needed: ``CostMode``, a ``TorchDispatchMode``, sees each
ATen op once per time it runs.  It counts, per rank:

* flops        -- ``torch.utils.flop_counter``'s formulas (2 * M * N * K
                  per product, the reference's ``_dot_flops``; attention
                  and convolution ops too);
* bytes        -- operands + results of every op that is not a view
                  (eager has no fusion, so every intermediate touches
                  memory once it is written and once each time it is
                  read: an upper bound, as the reference's count of
                  top-level instructions is);
* collectives  -- result bytes and counts per kind of the
                  ``_c10d_functional`` ops (``utils.op_analysis``);
* the peak of live bytes -- the bytes of the results still referenced
                  (each result is dropped from the count when its tensor
                  is freed), the counterpart of XLA's temp size.

The mode returns ``NotImplemented`` for an op with a DTensor argument:
DTensor then runs its sharding propagation, redistributes and calls the
op on each rank's local shards, and the mode sees those local ops and
the collectives -- the per-rank cost.  On the first call of an op
signature DTensor's propagation also runs the op at global shapes (on
fake tensors); the mode does not count those (it wraps the propagator
while it is on), and ``analyze``'s ``warmup`` call, which fills the
propagation cache first, gives the same count.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.utils.op_analysis import COLLECTIVES, OpRecord


@dataclass
class WeightedCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    # loops run in Python: every op is seen as often as it runs, so no
    # trip count weights anything (kept for the reference's record)
    trip_counts: Dict[str, int] = field(default_factory=dict)
    peak_live_bytes: float = 0.0
    log: List[OpRecord] = field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


# the DTensor method that runs an op at global shapes on fake tensors
_PROPAGATE = "_propagate_tensor_meta_non_cached"


def _tensors(seq) -> list:
    """The tensors among an op's arguments or results (one level of
    lists and tuples, as ATen signatures nest them)."""
    out = []
    for a in seq:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and live bytes of the local
    ops run under it (see the module docstring) into ``self.cost``.
    The ops DTensor runs at global shapes to propagate a sharding are
    not counted: its ``ShardingPropagator`` is wrapped while the mode is
    on, so a first call of an op signature counts as a later one."""

    def __init__(self, keep_log: bool = True):
        super().__init__()
        self.cost = WeightedCost()
        self.keep_log = keep_log
        self._live = 0
        self._seen: set = set()
        self._meta: dict = {}
        self._global = 0
        self._saved = None

    @staticmethod
    def hides_propagation() -> bool:
        """Whether this PyTorch lets the mode leave DTensor's global-shape
        propagation ops out (else count after a warm-up call)."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        return hasattr(ShardingPropagator, _PROPAGATE)

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = getattr(ShardingPropagator, _PROPAGATE, None)
        if orig is not None:
            mode = self

            def propagate(prop, op_schema):
                mode._global += 1
                try:
                    return orig(prop, op_schema)
                finally:
                    mode._global -= 1

            self._saved = (ShardingPropagator, orig)
            setattr(ShardingPropagator, _PROPAGATE, propagate)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._saved is not None:
            cls, orig = self._saved
            setattr(cls, _PROPAGATE, orig)
            self._saved = None
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s bytes live until its storage is freed."""
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            key = id(t)
        if key in self._seen:
            return
        self._seen.add(key)
        n = _nbytes(t)
        self._live += n
        if self._live > self.cost.peak_live_bytes:
            self.cost.peak_live_bytes = self._live
        weakref.finalize(t, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._live -= n
        self._seen.discard(key)

    def _info(self, func):
        """(name, counts bytes, flop formula, collective kind) of an op."""
        info = self._meta.get(func)
        if info is None:
            name = func.name()
            ns, _, op = name.partition("::")
            op = op.split(".")[0]
            coll = COLLECTIVES.get(op) if ns == "_c10d_functional" else None
            moves = (not func.is_view
                     and name != "_c10d_functional::wait_tensor")
            info = (name, moves, flop_registry.get(func._overloadpacket),
                    coll, func.is_view)
            self._meta[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim" or self._global:
            return func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        if any(isinstance(a, DTensor) for a in ins):
            return NotImplemented
        out = func(*args, **kwargs)
        name, moves, flop_fn, coll, is_view = self._info(func)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        c = self.cost
        rec = OpRecord(name, collective=coll)
        rec.out_bytes = sum(_nbytes(t) for t in outs)
        if flop_fn is not None:
            rec.flops = float(flop_fn(*args, **kwargs, out_val=out))
            c.flops += rec.flops
        if coll is not None:
            c.collective_bytes[coll] = (c.collective_bytes.get(coll, 0.0)
                                        + rec.out_bytes)
            c.collective_counts[coll] = c.collective_counts.get(coll, 0.0) + 1
        if moves:
            rec.bytes = float(sum(_nbytes(t) for t in ins) + rec.out_bytes)
            c.bytes_accessed += rec.bytes
        if not is_view:
            in_ids = {id(t) for t in ins}
            for t in outs:
                if id(t) not in in_ids:
                    self._track(t)
        if self.keep_log:
            c.log.append(rec)
        return out


def analyze(fn, *args, warmup: bool = True, **kwargs) -> WeightedCost:
    """The per-rank cost of ``fn(*args, **kwargs)``: one call first when
    ``warmup`` (it fills DTensor's sharding-propagation cache, see the
    module docstring), then one call counted under ``CostMode``.  The
    mode leaves the propagation's global-shape ops out of the count by
    itself, so ``warmup=False`` counts the same at half the time (the
    dry run's choice)."""
    if warmup or not CostMode.hides_propagation():
        fn(*args, **kwargs)
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.cost
