"""The counts a step makes, in one table: ``COUNTS``.

Every count lives here by name: each hand-written kernel's launches
(counted by its launcher, ``kernels/build.py`` ``kernel``, under the
kernel's name), ``ssd_scan``'s launches by body (``ssd_scan.recurrence``,
``ssd_scan.chunked``) and published Zamba2's shared-block applications
(``shared_applications``).  A module bumps its counts by 0 at import, so
the table names them before their first run.  ``read`` returns every
count and ``add`` moves them, which is how ``serving/capture.py`` takes
back what a CUDA graph's capture counted and adds it again on every
replay.
"""
from __future__ import annotations

from typing import Dict

COUNTS: Dict[str, int] = {}


def bump(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` (a new name starts at 0)."""
    COUNTS[name] = COUNTS.get(name, 0) + n


def read() -> Dict[str, int]:
    """Every count so far."""
    return dict(COUNTS)


def add(delta: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times each count of ``delta`` to its count."""
    for name, n in delta.items():
        bump(name, sign * n)


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """The counts that moved from ``before`` to ``after``, by how much."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def reset() -> None:
    """Every count set to 0."""
    for name in COUNTS:
        COUNTS[name] = 0
