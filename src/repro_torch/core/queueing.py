"""EDF queue + dynamic batcher (paper §3.1 "Queuing").

Copy of ``repro.core.queueing`` cut to ``EDFQueue`` (push/pop/peek,
mid-flight re-keying and cancellation, the solvers' snapshots --
``snapshot_remaining`` / ``remaining_array`` for the fixed-work solver,
``token_snapshot`` for the token solver -- and ``drop_expired``) and
``DynamicBatcher``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.slo import Request


class EDFQueue:
    """EDF heap of ``Request`` objects with mid-flight re-keying.

    ``_live`` maps ``req.id`` to the queued ``Request``; a heap tuple
    ``(deadline, id, req)`` is live iff the id is still mapped to that
    object *and* the tuple's deadline matches ``req.deadline`` (updates
    mutate the request's deadline and re-push, so superseded tuples
    fail the second check).
    """

    def __init__(self):
        self._heap: list[tuple[float, int, Request]] = []
        self._live: Dict[int, Request] = {}

    @staticmethod
    def _key(req: Request) -> float:
        """Heap ordering key: the absolute deadline (EDF)."""
        return req.deadline

    def __len__(self):
        return len(self._live)

    def push(self, req: Request) -> None:
        self._live[req.id] = req
        heapq.heappush(self._heap, (self._key(req), req.id, req))

    def _fix_top(self) -> None:
        """Restore the top-live invariant (drop stale root tuples)."""
        h, live = self._heap, self._live
        while h:
            key, rid, req = h[0]
            if live.get(rid) is req and self._key(req) == key:
                return
            heapq.heappop(h)

    def __contains__(self, rid: int) -> bool:
        return rid in self._live

    def update_deadline(self, rid: int, new_deadline: float) -> bool:
        """Re-key a queued request to ``new_deadline`` (mid-flight SLO
        renegotiation).  Lazy invalidation: the request object's
        deadline is rewritten and — when the ordering key moved — a
        fresh heap entry pushed; the stale tuple is discarded when it
        surfaces.  Returns False when the id is not queued (already
        dispatched / cancelled / unknown)."""
        req = self._live.get(rid)
        if req is None:
            return False
        if req.deadline == new_deadline:
            return True
        old_key = self._key(req)
        req.deadline = new_deadline
        if self._key(req) != old_key:
            heapq.heappush(self._heap, (self._key(req), rid, req))
            self._fix_top()
        return True

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a queued request (client abandoned it).  Returns the
        request, or None when it is not queued (double-cancel safe)."""
        req = self._live.pop(rid, None)
        if req is not None:
            self._fix_top()
        return req

    def pop(self) -> Request:
        h, live = self._heap, self._live
        while True:
            key, rid, req = heapq.heappop(h)
            if live.get(rid) is req and self._key(req) == key:
                del live[rid]
                self._fix_top()
                return req

    def peek(self) -> Optional[Request]:
        return self._heap[0][2] if self._heap else None

    def pop_batch(self, b: int) -> List[Request]:
        return [self.pop() for _ in range(min(b, len(self._live)))]

    def live_requests(self) -> List[Request]:
        """The live-entry snapshot: every queued request exactly once.

        This — never ``_heap`` — is the observer-facing view.  After an
        ``update_deadline`` the heap holds stale duplicates of the re-keyed
        request, and after a ``cancel`` it still holds the dead tuple;
        only ``_live`` reflects the queue's true contents.
        """
        return list(self._live.values())

    def snapshot_remaining(self, now: float) -> List[float]:
        """Remaining budgets (sorted ascending) — the solver's input."""
        return sorted(r.deadline - now for r in self._live.values())

    def remaining_array(self, now: float) -> np.ndarray:
        """Vectorized ``snapshot_remaining``: sorted np.float64 budgets."""
        dl = np.fromiter((r.deadline for r in self._live.values()),
                         np.float64, len(self._live))
        return np.sort(dl - now)

    def token_snapshot(self, now: float):
        """Token-aware solver input: ``(ttft_budgets, prompt_tokens,
        tbt_min)`` with budgets EDF-sorted ascending, token counts
        aligned to that order, and the tightest per-token SLO queued
        (``inf`` when empty or all-fixed-work)."""
        if not self._live:
            return (np.empty(0, np.float64), np.empty(0, np.float64),
                    float("inf"))
        reqs = list(self._live.values())
        dl = np.fromiter((r.deadline for r in reqs), np.float64, len(reqs))
        toks = np.fromiter((r.prompt_tokens for r in reqs), np.float64,
                           len(reqs))
        tbt = min(r.tbt_slo for r in reqs)
        order = np.argsort(dl, kind="stable")
        return dl[order] - now, toks[order], float(tbt)

    def drop_expired(self, now: float) -> List[Request]:
        """Remove requests whose deadline already passed (counted as
        violations by the caller)."""
        dropped = [r for r in self._live.values() if r.deadline < now]
        if dropped:
            for r in dropped:
                del self._live[r.id]
            self._heap = [(self._key(r), r.id, r)
                          for r in self._live.values()]
            heapq.heapify(self._heap)
        return dropped


class DynamicBatcher:
    """Forms batches of the scaler's current b from the EDF queue."""

    def __init__(self, queue: EDFQueue, b: int = 1):
        self.queue = queue
        self.b = b

    def set_batch_size(self, b: int) -> None:
        if b < 1:
            raise ValueError(f"batch size must be >= 1, got {b}")
        self.b = b

    def next_batch(self) -> List[Request]:
        return self.queue.pop_batch(self.b)

    def has_work(self) -> bool:
        return len(self.queue) > 0
