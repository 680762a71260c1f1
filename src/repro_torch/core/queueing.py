"""EDF queue + dynamic batcher (paper §3.1 "Queuing").

Copy of ``repro.core.queueing`` cut to ``EDFQueue`` (push/pop/peek,
mid-flight re-keying and cancellation, the solvers' snapshots --
``snapshot_remaining`` / ``remaining_array`` for the fixed-work solver,
``token_snapshot`` for the token solver -- and ``drop_expired``),
``DynamicBatcher``, and the fast engines' ``FastEDFQueue`` and
``TokenFastEDFQueue``: heaps of bare ``(deadline, index)`` pairs into a
struct-of-arrays workload, with the same re-keying and cancellation
(the fleet and vector engines' ``push_many`` / ``pop_ready`` /
``drain`` / ``peek_deadline`` are left out).  Both substrates keep the
top-live invariant after every mutation: the heap's root is always a
live entry, so the fast engines' inlined dispatch loops read
``_heap[0][0]`` (head deadline) and ``bool(_heap)`` (emptiness)
directly.
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


class FastEDFQueue:
    """EDF queue over request *indices* — the fast-path substrate.

    Entries are bare ``(deadline, index)`` tuples pointing into a
    struct-of-arrays workload (``serving.workload.RequestBatch``), so a
    million queued requests cost two machine words each and no
    object allocation.  Presents the same read surface the scheduling
    policies use (``__len__`` / ``snapshot_remaining`` /
    ``remaining_array``), which lets any decide-protocol
    ``SchedulingPolicy`` run unmodified on the fast path.

    ``_live`` (index → current deadline) carries the renegotiation
    state: ``update_deadline`` re-pushes under the new key,  ``cancel``
    drops the mapping, and pops skip tuples whose deadline no longer
    matches.  The top-live invariant holds after every mutation, so the
    inlined dispatch loops may keep reading ``_heap[0][0]`` (head
    deadline) and ``bool(_heap)`` (emptiness) directly; live *counts*
    must come from ``len(queue)`` / ``_live``.
    """

    def __init__(self):
        self._heap: list[tuple[float, int]] = []
        self._live: Dict[int, float] = {}

    def __len__(self):
        return len(self._live)

    def push(self, deadline: float, idx: int) -> None:
        self._live[idx] = deadline
        heapq.heappush(self._heap, (deadline, idx))

    def _fix_top(self) -> None:
        """Restore the top-live invariant (drop stale root tuples)."""
        h, live = self._heap, self._live
        while h and live.get(h[0][1]) != h[0][0]:
            heapq.heappop(h)

    def update_deadline(self, idx: int, new_deadline: float) -> bool:
        """Re-key a queued index to ``new_deadline``; False when the
        index is not queued (dispatched / cancelled / unknown)."""
        old = self._live.get(idx)
        if old is None:
            return False
        if old == new_deadline:
            return True
        self._live[idx] = new_deadline
        heapq.heappush(self._heap, (new_deadline, idx))
        self._fix_top()
        return True

    def cancel(self, idx: int) -> bool:
        """Remove a queued index; False when it is not queued
        (double-cancel safe)."""
        if self._live.pop(idx, None) is None:
            return False
        self._fix_top()
        return True

    def pop_batch(self, b: int) -> List[int]:
        """Pop the ≤b earliest-deadline live request indices (EDF
        order), discarding stale tuples as they surface."""
        pop = heapq.heappop
        h, live = self._heap, self._live
        out: List[int] = []
        while h and len(out) < b:
            dl, idx = pop(h)
            if live.get(idx) == dl:
                del live[idx]
                out.append(idx)
        self._fix_top()
        return out

    def remaining_array(self, now: float) -> np.ndarray:
        """Sorted remaining budgets — one vectorized pass over the
        live-entry map."""
        dl = np.fromiter(self._live.values(), np.float64, len(self._live))
        return np.sort(dl - now)

    def snapshot_remaining(self, now: float) -> List[float]:
        return self.remaining_array(now).tolist()


class TokenFastEDFQueue(FastEDFQueue):
    """Fast-path EDF queue bound to a struct-of-arrays token workload.

    ``bind`` attaches the workload's per-request ``prompt_tokens`` and
    ``tbt_slo`` columns once; ``token_snapshot`` then assembles the
    token-aware solver input (EDF-sorted budgets, aligned token counts,
    tightest queued TBT) from the live-entry map with three vectorized
    passes — the same no-objects discipline as :class:`FastEDFQueue`.
    """

    def __init__(self):
        super().__init__()
        self._prompt_tokens: Optional[np.ndarray] = None
        self._tbt: Optional[np.ndarray] = None

    def bind(self, prompt_tokens: np.ndarray, tbt_slo: np.ndarray) -> None:
        """Attach the workload columns the snapshots index into."""
        self._prompt_tokens = np.asarray(prompt_tokens, np.float64)
        self._tbt = np.asarray(tbt_slo, np.float64)

    def token_snapshot(self, now: float):
        """Same contract as ``EDFQueue.token_snapshot``."""
        if not self._live:
            return (np.empty(0, np.float64), np.empty(0, np.float64),
                    float("inf"))
        assert self._prompt_tokens is not None, "bind() the workload first"
        n = len(self._live)
        dl = np.fromiter(self._live.values(), np.float64, n)
        idx = np.fromiter(self._live.keys(), np.int64, n)
        order = np.argsort(dl, kind="stable")
        toks = self._prompt_tokens[idx[order]]
        tbt = float(self._tbt[idx].min())
        return dl[order] - now, toks, tbt


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
