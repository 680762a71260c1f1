"""The port's predictive scaling against the JAX package.

``core/predictive.py`` is a copy of the reference's: the Holt forecaster,
``PredictiveSpongeScaler``, ``PredictivePolicy`` (``sponge-pred``) and
``TelemetryPolicy`` take the same observations to the same forecasts and
decisions.  Mirrors ``tests/test_predictive.py`` and runs ``sponge-pred``
end to end through ``run_scenario``, equal to the reference's exact
engine.
"""
import numpy as np
import pytest

from repro.core import predictive as jpred
from repro.core.perf_model import yolov5s_like as jax_yolo
from repro.core.queueing import EDFQueue as JaxQueue
from repro.core.scaler import SpongeScaler as JaxSpongeScaler
from repro.core.slo import Request as JaxRequest
from repro.network.traces import BandwidthTrace as JaxTrace
from repro.serving import api as japi
from repro.serving import scenarios as jax_scenarios
from repro_torch.core.perf_model import yolov5s_like
from repro_torch.core.predictive import (HoltForecaster, PredictivePolicy,
                                         PredictiveSpongeScaler,
                                         TelemetryPolicy)
from repro_torch.core.queueing import EDFQueue
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.slo import Request
from repro_torch.network.traces import BandwidthTrace
from repro_torch.serving import api
from repro_torch.serving.scenarios import run_scenario


def decision(d):
    return (d.c, d.b, d.feasible, d.solver_iters, d.n)


def test_holt_tracks_level_and_trend():
    f, ref = HoltForecaster(alpha=0.5, beta=0.3), \
        jpred.HoltForecaster(alpha=0.5, beta=0.3)
    assert f.forecast() == 0.0
    for i in range(20):
        f.observe(0.1 + 0.01 * i)          # rising comm latency
        ref.observe(0.1 + 0.01 * i)
    assert f.forecast(1.0) > f.level and f.trend > 0
    assert (f.level, f.trend, f.forecast(2.5)) == \
        (ref.level, ref.trend, ref.forecast(2.5))


def test_predictive_scaler_tightens_budgets_on_rising_cl():
    out = []
    for base_cls, pred_cls, queue_cls, req_cls, perf in (
            (SpongeScaler, PredictiveSpongeScaler, EDFQueue, Request,
             yolov5s_like()),
            (JaxSpongeScaler, jpred.PredictiveSpongeScaler, JaxQueue,
             JaxRequest, jax_yolo())):
        base, pred = base_cls(perf), pred_cls(perf)
        for i in range(20):
            pred.observe_comm_latency(0.05 + 0.03 * i)
        queues = []
        for _ in range(2):
            q = queue_cls()
            for _ in range(10):
                q.push(req_cls.make(arrival=0.0, comm_latency=0.3, slo=1.0))
            queues.append(q)
        d_base = base.decide(0.0, queues[0], lam=20.0)
        d_pred = pred.decide(0.0, queues[1], lam=20.0)
        assert pred.forecast_increase() > 0
        assert d_pred.c >= d_base.c, "rising-cl forecast must not scale DOWN"
        assert pred.headroom == base.headroom      # restored after decide
        out.append((decision(d_base), decision(d_pred),
                    pred.forecast_increase()))
    assert out[0] == out[1]


def test_telemetry_policy_injects_inflight_budgets():
    """0.5 MB/s -> cl ~0.41 s -> ~8 in-flight requests injected; the
    solver provisions for their shrunken budgets despite an empty queue,
    as the reference's does."""
    decisions = []
    for trace_cls, perf, scaler_cls, pol_cls, mod in (
            (BandwidthTrace, yolov5s_like(), SpongeScaler, TelemetryPolicy,
             api),
            (JaxTrace, jax_yolo(), JaxSpongeScaler, jpred.TelemetryPolicy,
             japi)):
        tr = trace_cls(t=np.arange(10.0), mbps=np.full(10, 0.5))
        sc = scaler_cls(perf)
        pol = pol_cls(sc, tr, size_kb=200, slo=1.0)
        sim = mod.ScenarioRunner(pol, mod.SimBackend(perf, range(1, 17),
                                                     range(1, 17), c0=4))
        sim.monitor.rate.prior_rps = 20
        pol.on_tick(0.0, sim)
        assert len(sc.decisions) == 1 and pol.decisions is sc.decisions
        assert sc.decisions[0][1].c > 1
        decisions.append(decision(sc.decisions[0][1]))
    assert decisions[0] == decisions[1]


def test_predictive_feed_reads_live_snapshot_not_heap():
    """A deadline re-key leaves a stale duplicate in the raw heap and a
    cancel leaves a dead tuple: ``PredictivePolicy._feed`` observes each
    live request exactly once and never a cancelled one."""

    class _CountingScaler(PredictiveSpongeScaler):
        def __init__(self, perf):
            super().__init__(perf)
            self.fed = []

        def observe_comm_latency(self, cl):
            self.fed.append(cl)
            super().observe_comm_latency(cl)

    class _Sim:
        def __init__(self, queue, completed):
            self.queue = queue
            self.monitor = type("M", (), {"completed": completed})()

    q = EDFQueue()
    kept = Request.make(arrival=0.0, comm_latency=0.11, slo=1.0)
    rekeyed = Request.make(arrival=2.0, comm_latency=0.22, slo=1.0)
    doomed = Request.make(arrival=5.0, comm_latency=0.33, slo=1.0)
    for r in (kept, rekeyed, doomed):
        q.push(r)
    assert q.update_deadline(rekeyed.id, rekeyed.deadline + 0.5)
    assert q.cancel(doomed.id) is doomed
    assert len(q._heap) > len(q)
    pol = PredictivePolicy(_CountingScaler(yolov5s_like()))
    pol._feed(_Sim(q, completed=[]))
    assert sorted(pol.scaler.fed) == [0.11, 0.22]
    pol._feed(_Sim(q, completed=[]))
    assert sorted(pol.scaler.fed) == [0.11, 0.22]


def test_make_policy_knows_sponge_pred():
    assert "sponge-pred" in api.POLICY_NAMES
    assert api.POLICY_NAMES == japi.POLICY_NAMES
    pol = api.make_policy("sponge-pred", yolov5s_like(),
                          adaptation_interval=0.5)
    assert isinstance(pol, PredictivePolicy) and pol.name == "sponge-pred"
    assert pol.scaler.adaptation_interval == 0.5


@pytest.mark.parametrize("name", ["steady", "network-replay",
                                  "slo-renegotiation"])
def test_sponge_pred_runs_equal_reference(name):
    rep, stats = run_scenario(name, policy="sponge-pred", engine="exact",
                              duration=30, seed=6)
    jrep, jstats = jax_scenarios.run_scenario(name, policy="sponge-pred",
                                              engine="exact", duration=30,
                                              seed=6)
    assert rep.policy == "sponge-pred" and rep.n_requests > 0
    assert [(t, decision(d)) for t, d in rep.decisions] == \
        [(t, decision(d)) for t, d in jrep.decisions]
    assert rep.buckets == jrep.buckets
    assert repr((rep.violation_rate, rep.p50, rep.p99, rep.avg_cores)) == \
        repr((jrep.violation_rate, jrep.p50, jrep.p99, jrep.avg_cores))
    assert stats.get("session") == jstats.get("session")
