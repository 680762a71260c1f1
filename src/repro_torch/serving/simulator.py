"""Discrete-event cluster simulator for the Fig. 4 study -- a thin
construction shim over the unified serving API.

.. deprecated::
    New code should construct through ``repro_torch.serving.api``
    (``make_sim_server`` or ``ScenarioRunner`` + ``SimBackend``), or use
    ``repro_torch.serving.fastpath.FastSimRunner`` for million-request
    traces.  This module remains only for callers of the historical
    ``ClusterSimulator`` signature.

Copy of ``repro.serving.simulator``.  The event loop, EDF dispatch,
pool management and reporting live in
``repro_torch.serving.api.ScenarioRunner``; this module only binds it to a
``SimBackend`` (batch finish times from the calibrated PerfModel) with the
historical constructor signature.  The same runner drives the live engine
(``repro_torch.serving.engine``) — only the ExecutionBackend differs.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

from repro_torch.core.perf_model import PerfModel
from repro_torch.core.slo import Request
from repro_torch.serving.api import (RunReport, ScenarioRunner, Server,
                                     SimBackend)

warnings.warn(
    "repro_torch.serving.simulator is deprecated: construct through "
    "repro_torch.serving.api (make_sim_server / ScenarioRunner + "
    "SimBackend) or repro_torch.serving.fastpath.FastSimRunner for "
    "million-request traces",
    DeprecationWarning, stacklevel=2)

__all__ = ["ClusterSimulator", "Server", "simulate"]


class ClusterSimulator(ScenarioRunner):
    """ScenarioRunner preconfigured with a SimBackend.

    Deprecated shim — prefer ``repro_torch.serving.api.make_sim_server``.
    Accepts both decide-protocol policies (``repro_torch.serving.api``) and
    legacy ``on_tick(now, sim)`` policies that mutate the pool directly.
    """

    def __init__(self, perf: PerfModel, policy,
                 c_set: Sequence[int], b_set: Sequence[int],
                 tick: float = 1.0, c0: int = 1,
                 resize_penalty: float = 0.005,
                 dispatch_margin: float = 0.02):
        self.perf = perf
        backend = SimBackend(perf, c_set, b_set, c0=c0,
                             resize_penalty=resize_penalty)
        super().__init__(policy, backend, tick=tick,
                         dispatch_margin=dispatch_margin)

    @property
    def dead(self) -> List[Server]:
        return self.backend.dead


def simulate(perf: PerfModel, policy, requests: List[Request],
             c_set, b_set, tick: float = 1.0, c0: int = 1,
             horizon: Optional[float] = None,
             resize_penalty: float = 0.005) -> RunReport:
    sim = ClusterSimulator(perf, policy, c_set, b_set, tick=tick, c0=c0,
                           resize_penalty=resize_penalty)
    return sim.run(requests, horizon)
