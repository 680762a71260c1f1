"""The Sponge serving package of the PyTorch port: one control plane,
pluggable everything.  Counterpart of ``repro.serving``, with
``TorchBackend`` in place of the reference's ``JaxBackend``.

Public surface (snapshotted by ``tests/test_torch_public_api.py``):

* construction — ``make_sim_server`` / ``make_live_server`` /
  ``make_policy`` and the ``SpongeServer`` facade;
* engines — the object-based ``ScenarioRunner`` (+ ``SimBackend`` /
  ``TorchBackend``) and the struct-of-arrays ``FastSimRunner`` /
  ``TokenFastSimRunner`` (import from ``repro_torch.serving.fastpath``)
  and fleet runners (``repro_torch.serving.fleet``);
* the online session API — ``SpongeSession`` protocol, the per-engine
  sessions, transcripts (``repro_torch.serving.session``);
* workloads — ``WorkloadGenerator`` / ``RequestBatch`` and the scenario
  registry (``repro_torch.serving.scenarios``);
* multi-tenancy — ``TenantPool`` / ``TenantSpec`` and the shared-pool
  engines (``repro_torch.serving.tenancy``).

The deprecated shims (``ClusterSimulator`` / ``simulate`` in
``repro_torch.serving.simulator``, ``ServingEngine`` in
``repro_torch.serving.engine``) are not re-exported here and warn on
import.
"""
from repro_torch.serving.workload import RequestBatch, WorkloadGenerator
from repro_torch.serving.api import (RunReport, ScenarioRunner, SimBackend,
                                     SpongeServer, TorchBackend,
                                     make_live_server, make_policy,
                                     make_sim_server, round_up_c)
from repro_torch.serving.session import (ExactSession, FastSession,
                                         FleetSession, SessionTranscript,
                                         SpongeSession, TokenFastSession,
                                         drive_session_events,
                                         replay_transcript)
from repro_torch.serving.tenancy import TenantPool, TenantSpec

__all__ = [
    "ExactSession", "FastSession", "FleetSession", "RequestBatch",
    "RunReport", "ScenarioRunner", "SessionTranscript", "SimBackend",
    "SpongeServer", "SpongeSession", "TenantPool", "TenantSpec",
    "TokenFastSession", "TorchBackend", "WorkloadGenerator",
    "drive_session_events", "make_live_server", "make_policy",
    "make_sim_server", "replay_transcript", "round_up_c",
]
