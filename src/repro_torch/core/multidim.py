"""Beyond-paper: joint vertical + horizontal scaling.

Copy of the reference's deprecated ``repro.core.multidim`` shim.  The
paper's §6 "Multidimensional scaling" future work: vertical scaling
saturates at c_max on one node; when the workload exceeds a single
instance's max throughput, horizontal replicas must join — each of which is
itself vertically scaled.

.. deprecated::
    The ``rem_all[::k]`` share-splitting heuristic here is superseded by
    the joint (n, c, b) solver (``repro_torch.core.solver.JointSolverTable``
    / ``JointMemoizedSolver`` driving ``repro_torch.serving.fleet``),
    which searches replica count, cores and batch jointly instead of
    slicing a fixed share per instance.  Importing this module emits a
    ``DeprecationWarning``.

Policy:

* target replica count n = ceil(lambda_eff / h_max(c_max)) (backlog-aware);
  scale-ups pay the cold start (new instances ARE new pods — the paper's
  point is that the cold start is only paid on the horizontal axis);
* each tick, run the Sponge IP with the per-instance share lambda/n and the
  global queue snapshot interleaved n-ways (EDF order is preserved per
  instance because the simulator pool shares one EDF queue);
* all live instances resize in place to the solved c.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

from repro_torch.core.scaler import SpongeScaler

warnings.warn(
    "repro_torch.core.multidim is deprecated: the per-instance "
    "share-splitting heuristic is superseded by the joint (n, c, b) "
    "solver — use repro_torch.core.solver.JointSolverTable / "
    "JointMemoizedSolver with repro_torch.serving.fleet",
    DeprecationWarning, stacklevel=2)


@dataclass
class MultiDimPolicy:
    scaler: SpongeScaler
    cold_start: float = 10.0
    max_instances: int = 8
    drain_horizon: float = 5.0
    name: str = "sponge-multidim"

    def h_max(self) -> float:
        c = max(self.scaler.c_set)
        return max(float(self.scaler.perf.throughput(b, c))
                   for b in self.scaler.b_set)

    def on_tick(self, now: float, sim) -> None:
        if not self.scaler.due(now):
            return
        lam = sim.monitor.rate.rate(now)
        lam_eff = lam + len(sim.queue) / self.drain_horizon
        n = max(1, min(self.max_instances,
                       math.ceil(lam_eff / max(self.h_max(), 1e-9))))
        cur = len(sim.pool)
        if n > cur:
            for _ in range(n - cur):
                sim.add_server(max(self.scaler.c_set),
                               ready_at=now + self.cold_start)
        elif n < cur:
            sim.remove_servers(cur - n, now)
        ready = [s for s in sim.pool if s.ready_at <= now] or sim.pool
        # per-instance share: every k-th queued budget, lambda/k arrivals
        k = len(ready)
        rem_all = sim.queue.snapshot_remaining(now)
        wait0 = min(max(s.busy_until - now, 0.0) for s in ready)
        d = _decide_shared(self.scaler, now, rem_all[::k], lam / k,
                           initial_wait=wait0)
        sim.set_batch(d.b)
        for srv in ready:
            penalty = srv.instance.resize(d.c, now)
            if penalty:
                srv.busy_until = max(srv.busy_until, now) + penalty


def _decide_shared(self, now, remaining, lam, initial_wait=0.0):
    """``SpongeScaler.decide`` on a pre-sliced budget list (module-local
    helper — this used to be monkey-patched onto ``SpongeScaler`` at
    import time, mutating the class for every other consumer)."""
    from repro_torch.core.solver import solve_bruteforce, solve_pruned
    self._next_t = now + self.adaptation_interval
    rem = sorted(max(r - self.headroom, 0.0) for r in remaining)
    fn = solve_bruteforce if self.solver == "bruteforce" else solve_pruned
    d = fn(rem, lam * self.lam_headroom, self.perf, self.c_set, self.b_set,
           self.delta_pen, initial_wait=initial_wait)
    self.decisions.append((now, d))
    return d

