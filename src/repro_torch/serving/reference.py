"""The pre-refactor Sponge event loop, kept verbatim as an oracle.

Copy of ``repro.serving.reference``: the ``ScenarioRunner.run`` /
``_dispatch`` pair as it was before the streamed-event refactor: every
arrival and every adaptation tick is heap-pushed up front, and each
event triggers a linear scan over the server pool.  It is correct and
easy to audit, and it is the reference that
``tests/test_torch_fastpath.py`` holds the streamed runner and the
struct-of-arrays fast path decision-equivalent to.

Do not "optimize" this module: its value is that it does NOT share code
with the production loop.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, Optional, Sequence

from repro_torch.serving.api import RunReport, ScenarioRunner


class ReferenceRunner(ScenarioRunner):
    """ScenarioRunner with the original (pre-refactor) event loop."""

    def run(self, arrivals: Sequence, horizon: Optional[float] = None
            ) -> RunReport:
        from repro_torch.core.slo import Request
        norm = [(a, None) if isinstance(a, Request) else (a[0], a[1])
                for a in arrivals]
        if horizon is None:
            horizon = (max(r.arrival for r, _ in norm) + 60.0
                       if norm else 60.0)
        events: list[tuple[float, int, str, object]] = []
        seq = itertools.count()
        self.events_processed = 0
        self._wake: Dict[int, float] = {}   # srv.id -> scheduled wake-up
        for r, payload in norm:
            heapq.heappush(events, (r.arrival, next(seq), "arrival",
                                    (r, payload)))
        t = 0.0
        while t <= horizon:
            heapq.heappush(events, (t, next(seq), "tick", None))
            t += self.tick

        while events:
            t, _, kind, item = heapq.heappop(events)
            if t > horizon:
                break
            self.events_processed += 1
            self.now = t
            if kind == "arrival":
                req, payload = item
                self.submit(req, payload)
            elif kind == "tick":
                if hasattr(self.policy, "on_tick"):
                    self.policy.on_tick(t, self)
                else:                       # bare SchedulingPolicy
                    self.drive(self.policy, t)
                self.core_samples.append((t, self.allocated_cores))
            # "free" / "check": fall through to the dispatch pass
            self._dispatch(t, events, seq)

        return self.results(horizon)

    def _dispatch(self, t: float, events, seq) -> None:
        for srv in self.pool:
            # a slot busy (or cold-starting) past this event with queued
            # work gets a precise wake-up: a resize penalty can extend
            # busy_until beyond the slot's scheduled "free" event, which
            # would otherwise strand the queue until the next tick
            wake_t = max(srv.ready_at, srv.busy_until)
            if (len(self.queue) and wake_t > t
                    and self._wake.get(srv.id) != wake_t):
                self._wake[srv.id] = wake_t
                heapq.heappush(events, (wake_t, next(seq), "check", srv.id))
            while (len(self.queue) and srv.ready_at <= t
                   and srv.busy_until <= t):
                q = len(self.queue)
                if q < self.b:
                    head = self.queue.peek()
                    l_full = srv.instance.latency(self.b)
                    t_force = head.deadline - l_full - self.dispatch_margin
                    if t < t_force:
                        # re-check when deadline pressure bites (new
                        # arrivals also re-trigger dispatch)
                        heapq.heappush(events, (min(t_force, t + self.tick),
                                                next(seq), "check", srv.id))
                        break
                batch = self.queue.pop_batch(self.b)
                bucket = srv.instance.bucket_b(len(batch))
                fin = self.backend.execute(batch, srv.instance.c, bucket, t)
                srv.busy_until = fin
                self.bucket_log.append((t, srv.instance.c, bucket,
                                        len(batch)))
                for r in batch:
                    r.start_proc = t
                    r.finish = fin
                    self.monitor.observe_completion(r)
                heapq.heappush(events, (fin, next(seq), "free", srv.id))
