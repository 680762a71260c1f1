"""The counts a step makes, in one table: ``COUNTERS``.

Each module keeps its counts where it increments them (a kernel wrapper
its module-level ``launches``, ``ssd_scan`` its launches by body,
published Zamba2 its shared-block applications) and registers each one
here by name as ``(the dict that holds it, its key)``; a module's own
attribute is held by ``vars(module)``.  ``read`` returns every count and
``add`` moves them, which is how ``serving/capture.py`` takes back what a
CUDA graph's capture counted and adds it again on every replay.
"""
from __future__ import annotations

from typing import Dict, MutableMapping, Tuple

# name -> (the dict that holds the count, its key)
COUNTERS: Dict[str, Tuple[MutableMapping, str]] = {}


def register(name: str, held: MutableMapping, key: str) -> None:
    """Add the count ``held[key]`` to the table under ``name``."""
    COUNTERS[name] = (held, key)


def read() -> Dict[str, int]:
    """Every registered count so far."""
    return {name: held[key] for name, (held, key) in COUNTERS.items()}


def add(delta: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times each count of ``delta`` to its counter."""
    for name, n in delta.items():
        held, key = COUNTERS[name]
        held[key] += sign * n


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """The counts that moved from ``before`` to ``after``, by how much."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}
