"""The port's fixed-work Sponge loop against the JAX package.

The paper's own control loop -- every adaptation interval, read the
queued requests' remaining budgets, solve Algorithm 1 over the fitted
``l(b, c)``, apply one ``(c, b)`` by in-place vertical resize, dispatch
EDF batches -- is a NumPy copy in the port, so the same inputs must give
the same fits, decisions, buckets and report figures, bit for bit.  The
live half (``build_llm_step_fns``, ``make_live_server``) must give the
reference's greedy token ids on the reduced models with the reference's
weights.  Tolerance is exact equality throughout.  Everything here runs
on the CPU.
"""
import contextlib
import dataclasses
import importlib
import io
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import baselines as jbase
from repro.core import cost_model as jcm
from repro.core import perf_model as jpm
from repro.core import queueing as jq
from repro.core import scaler as jsc
from repro.core import solver as jso
from repro.core.monitor import Monitor as JaxMonitor
from repro.core.slo import Request as JaxRequest
from repro.launch import serve as jax_launcher
from repro.models import build_model as jax_build
from repro.network.latency import comm_latency as jax_comm_latency
from repro.network.traces import synth_4g_trace as jax_trace
from repro.serving import api as japi
from repro.serving.workload import WorkloadGenerator as JaxWorkload
from repro_torch.configs import get_config
from repro_torch.core import baselines, cost_model, perf_model, queueing
from repro_torch.core import scaler as psc
from repro_torch.core import solver
from repro_torch.core.monitor import Monitor
from repro_torch.core.slo import Decision, Request
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, params_from_jax
from repro_torch.network.latency import comm_latency
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving import api
from repro_torch.serving.workload import WorkloadGenerator

ARCH = "smollm-135m-reduced"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the measured-clock tests
    time real model calls, and the test runner's parallel workers would
    otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def decision_key(d):
    """A Decision's fields without its wall-clock solver time."""
    out = dataclasses.asdict(d)
    out.pop("solver_time")
    return out


def stream(decisions):
    return [(t, decision_key(d)) for t, d in decisions]


def fields(pm):
    return dataclasses.asdict(pm)


# --------------------------------------------------------------------------
# perf model and cost model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("robust,outliers,seed", [
    (False, 0.0, 0), (True, 0.0, 1), (True, 0.15, 3), (True, 0.3, 7)])
def test_perf_model_fit_matches_reference(robust, outliers, seed):
    truth, jtruth = perf_model.yolov5s_like(), jpm.yolov5s_like()
    np.testing.assert_equal(fields(truth), fields(jtruth))
    bs, cs = range(1, 17), (1, 2, 4, 8, 16)
    samples = truth.sample_profile(bs, cs, noise=0.01,
                                   outlier_frac=outliers, seed=seed)
    assert samples == jtruth.sample_profile(bs, cs, noise=0.01,
                                            outlier_frac=outliers, seed=seed)
    fit = perf_model.PerfModel.fit(samples, robust=robust, seed=seed)
    jfit = jpm.PerfModel.fit(samples, robust=robust, seed=seed)
    np.testing.assert_equal(fields(fit), fields(jfit))
    np.testing.assert_array_equal(fit.latency_table(bs, cs),
                                  jfit.latency_table(bs, cs))


def test_table1_and_synthetic_match_reference():
    np.testing.assert_equal(fields(perf_model.fit_table1()),
                            fields(jpm.fit_table1()))
    assert perf_model.TABLE1_SAMPLES == jpm.TABLE1_SAMPLES
    np.testing.assert_equal(fields(perf_model.PerfModel.synthetic()),
                            fields(jpm.PerfModel.synthetic()))
    pm = perf_model.fit_table1()
    assert pm.r2 > 0.9       # the reference's test_table1_fit_quality
    for b, c, lat in perf_model.TABLE1_SAMPLES:
        assert abs(pm.latency(b, c) - lat) / lat < 0.35
    with pytest.raises(ValueError):
        perf_model.PerfModel.fit([(1, 1, 0.1)] * 3)


def test_fixed_work_cost_model_matches_reference():
    pm, jpm_ = perf_model.fit_table1(), jpm.fit_table1()
    fw, jfw = cost_model.as_cost_model(pm), jcm.as_cost_model(jpm_)
    assert isinstance(fw, cost_model.FixedWorkCostModel)
    assert isinstance(fw, cost_model.CostModel)
    assert cost_model.as_cost_model(fw) is fw
    bb, cc = np.meshgrid(np.arange(1, 17), np.arange(1, 17))
    for name in ("latency", "throughput", "batch_latency"):
        np.testing.assert_array_equal(getattr(fw, name)(bb, cc),
                                      getattr(jfw, name)(bb, cc))
    np.testing.assert_array_equal(fw.prefill_latency(cc, bb),
                                  jfw.prefill_latency(cc, bb))
    np.testing.assert_array_equal(fw.decode_latency(cc, bb),
                                  jfw.decode_latency(cc, bb))
    for comp in ((0, 3), (5, 0), (12, 4)):
        assert fw.step_latency(4, cost_model.Composition(*comp)) == \
            jfw.step_latency(4, jcm.Composition(*comp))


# --------------------------------------------------------------------------
# Algorithm 1 and its vectorized / memoized forms
# --------------------------------------------------------------------------
@pytest.mark.parametrize("perf_name", ["yolov5s_like", "fit_table1"])
@pytest.mark.parametrize("c_set", [solver.DEFAULT_C, (1, 2, 4, 8, 16)])
@pytest.mark.parametrize("seed", range(3))
def test_fixed_solvers_match_reference(perf_name, c_set, seed):
    perf, jperf = getattr(perf_model, perf_name)(), getattr(jpm, perf_name)()
    rng = np.random.default_rng(seed)
    table = solver.SolverTable(perf, c_set)
    jtable = jso.SolverTable(jperf, c_set)
    memo = solver.MemoizedSolver(perf, c_set, budget_quantum=0.02,
                                 lam_quantum=0.5)
    jmemo = jso.MemoizedSolver(jperf, c_set, budget_quantum=0.02,
                               lam_quantum=0.5)
    exact = solver.MemoizedSolver(perf, c_set)
    jexact = jso.MemoizedSolver(jperf, c_set)
    for _ in range(40):
        n = int(rng.integers(0, 40))
        rem = list(rng.uniform(0.0, 3.0, n))
        lam = float(rng.choice([0.0, rng.uniform(0, 60)]))
        wait = float(rng.choice([0.0, rng.uniform(0, 0.5)]))
        for fn, jfn in ((solver.solve_bruteforce, jso.solve_bruteforce),
                        (solver.solve_pruned, jso.solve_pruned)):
            assert decision_key(fn(rem, lam, perf, c_set,
                                   initial_wait=wait)) == \
                decision_key(jfn(rem, lam, jperf, c_set, initial_wait=wait))
        for mine, ref in ((table, jtable), (memo, jmemo), (exact, jexact)):
            assert decision_key(mine.solve(rem, lam, initial_wait=wait)) \
                == decision_key(ref.solve(rem, lam, initial_wait=wait))
        assert solver._predicted_violations(sorted(rem), 0.2, 3, wait) == \
            jso._predicted_violations(sorted(rem), 0.2, 3, wait)
    assert (memo.hits, memo.misses) == (jmemo.hits, jmemo.misses)


def test_reference_solver_cases_hold_on_the_port():
    """``tests/test_solver.py``'s fixed cases, on the port's copy."""
    perf = perf_model.yolov5s_like()
    d = solver.solve_bruteforce([], 0.0, perf)
    assert d.feasible and (d.c, d.b) == (1, 1)
    d = solver.solve_bruteforce([10.0] * 4, 20.0, perf)
    assert d.feasible and perf.throughput(d.b, d.c) >= 20.0
    t1 = perf_model.fit_table1()
    d = solver.solve_bruteforce([0.4] * 10, 100.0, t1)
    assert d.feasible and d.c >= 4
    assert not solver.solve_bruteforce([0.4] * 10, 100.0, t1,
                                       c_set=(1,)).feasible


# --------------------------------------------------------------------------
# queue, batcher, monitor, network
# --------------------------------------------------------------------------
def _twin_queues(rows):
    q, jqq = queueing.EDFQueue(), jq.EDFQueue()
    reqs, jreqs = [], []
    for arrival, cl, slo in rows:
        reqs.append(Request.make(arrival=arrival, comm_latency=cl, slo=slo))
        jreqs.append(JaxRequest.make(arrival=arrival, comm_latency=cl,
                                     slo=slo))
        q.push(reqs[-1])
        jqq.push(jreqs[-1])
    return (q, reqs), (jqq, jreqs)


@pytest.mark.parametrize("seed", range(3))
def test_edf_snapshots_and_drops_match_reference(seed):
    rng = np.random.default_rng(seed)
    rows = [(float(rng.uniform(0, 10)), float(rng.uniform(0, 0.8)),
             float(rng.uniform(0.1, 2.0))) for _ in range(40)]
    (q, reqs), (jqq, jreqs) = _twin_queues(rows)
    q.update_deadline(reqs[4].id, 0.3)
    jqq.update_deadline(jreqs[4].id, 0.3)
    q.cancel(reqs[9].id)
    jqq.cancel(jreqs[9].id)
    for now in (0.0, 2.5):
        assert q.snapshot_remaining(now) == jqq.snapshot_remaining(now)
        np.testing.assert_array_equal(q.remaining_array(now),
                                      jqq.remaining_array(now))
        assert q.snapshot_remaining(now) == sorted(q.snapshot_remaining(now))
    assert [r.arrival for r in q.live_requests()] == \
        [r.arrival for r in jqq.live_requests()]
    now = float(rng.uniform(2, 8))
    dropped, jdropped = q.drop_expired(now), jqq.drop_expired(now)
    assert [r.arrival for r in dropped] == [r.arrival for r in jdropped]
    assert all(r.deadline < now for r in dropped)
    assert len(q) + len(dropped) == 39
    batcher = queueing.DynamicBatcher(q, 3)
    jbatcher = jq.DynamicBatcher(jqq, 3)
    seen = []
    while batcher.has_work():
        batch, jbatch = batcher.next_batch(), jbatcher.next_batch()
        assert 1 <= len(batch) <= 3
        assert [r.deadline for r in batch] == [r.deadline for r in jbatch]
        seen.extend(r.deadline for r in batch)
    assert seen == sorted(seen) and all(d >= now for d in seen)
    assert not jbatcher.has_work()
    with pytest.raises(ValueError):
        batcher.set_batch_size(0)


def test_monitor_drops_and_residuals_match_reference():
    mon, jmon = Monitor(), JaxMonitor()
    for i, (cl, fin) in enumerate([(0.1, 0.5), (0.2, 2.0), (0.05, 0.7)]):
        r = Request.make(arrival=float(i), comm_latency=cl, slo=1.0)
        jr = JaxRequest.make(arrival=float(i), comm_latency=cl, slo=1.0)
        r.finish, jr.finish = i + fin, i + fin
        mon.observe_completion(r)
        jmon.observe_completion(jr)
    mon.observe_drop(Request.make(arrival=5.0, comm_latency=0.1, slo=1.0))
    jmon.observe_drop(JaxRequest.make(arrival=5.0, comm_latency=0.1,
                                      slo=1.0))
    for p, m in ((0.1, 0.12), (0.3, 0.25)):
        mon.observe_perf_residual(p, m)
        jmon.observe_perf_residual(p, m)
    assert mon.perf_residuals == jmon.perf_residuals
    for k in ("n_total", "n_violations", "violation_rate"):
        assert getattr(mon, k) == getattr(jmon, k), k
    assert (mon.n_total, mon.n_violations) == (4, 2)
    assert mon.p(0.99) == jmon.p(0.99)


def test_comm_latency_matches_reference():
    trace, jtr = synth_4g_trace(60, seed=3), jax_trace(60, seed=3)
    for t in np.linspace(0, 59, 37):
        for kb in (10.0, 200.0, 900.0):
            assert comm_latency(kb, trace, t) == jax_comm_latency(kb, jtr, t)


# --------------------------------------------------------------------------
# scalers and baselines: decision streams on one script
# --------------------------------------------------------------------------
def _scripted_decisions(mod_scaler, mod_base, mod_queue, mod_pm, req_cls,
                        which):
    perf = mod_pm.yolov5s_like()
    if which.startswith("sponge-"):
        pol = mod_scaler.SpongeScaler(perf, solver=which[len("sponge-"):],
                                      adaptation_interval=0.5)
    elif which == "static-8":
        pol = mod_base.StaticPolicy(perf, cores=8)
    else:
        pol = mod_base.FA2Policy(perf, slo=1.0, expected_rps=20.0,
                                 reconfig_interval=2.0)
    rng = np.random.default_rng(11)
    q = mod_queue.EDFQueue()
    for step in range(40):
        now = 0.25 * step
        for _ in range(int(rng.integers(0, 6))):
            q.push(req_cls.make(arrival=now, slo=1.0,
                                comm_latency=float(rng.uniform(0.02, 0.7))))
        for _ in range(int(rng.integers(0, 4))):
            if len(q):
                q.pop()
        if pol.due(now):
            pol.decide(now, q, float(rng.uniform(0, 40)),
                       initial_wait=float(rng.uniform(0, 0.2)))
    return pol.decisions


@pytest.mark.parametrize("which", ["sponge-bruteforce", "sponge-pruned",
                                   "sponge-memo", "static-8", "fa2"])
def test_policy_decision_streams_match_reference(which):
    mine = _scripted_decisions(psc, baselines, queueing, perf_model, Request,
                               which)
    ref = _scripted_decisions(jsc, jbase, jq, jpm, JaxRequest, which)
    assert mine and stream(mine) == stream(ref)


# --------------------------------------------------------------------------
# the simulated loop: make_sim_server over a 4G trace, all four policies
# --------------------------------------------------------------------------
SIM = dict(rps=20.0, slo=1.0, size_kb=200.0, duration=60, seed=7)


@pytest.fixture(scope="module", params=[p for p, _ in launcher.SIM_POLICIES])
def sim_runs(request):
    name = request.param
    kw = dict(launcher.SIM_POLICIES)[name]
    out = []
    for mod, pm, trace_fn, wl_cls in (
            (api, perf_model, synth_4g_trace, WorkloadGenerator),
            (japi, jpm, jax_trace, JaxWorkload)):
        server = mod.make_sim_server(
            pm.yolov5s_like(), name, prior_rps=SIM["rps"], slo=SIM["slo"],
            expected_rps=SIM["rps"], **kw)
        wl = wl_cls(rps=SIM["rps"], slo=SIM["slo"], size_kb=SIM["size_kb"])
        out.append((server, server.serve(wl, trace_fn(SIM["duration"],
                                                      seed=SIM["seed"]))))
    return name, out


def test_sim_server_report_equals_reference(sim_runs):
    _, ((_, rep), (_, jrep)) = sim_runs
    for k in ("n_requests", "n_violations", "violation_rate", "avg_cores",
              "core_seconds", "p50", "p99", "mean_latency", "buckets",
              "core_timeline"):
        assert rep[k] == jrep[k], k
    assert stream(rep.decisions) == stream(jrep.decisions)
    assert rep.n_requests > 1000 and rep.buckets


def test_sim_server_invariants(sim_runs):
    """``tests/test_simulator.py``'s invariants, on the port's runner."""
    name, ((server, rep), _) = sim_runs
    done = server.monitor.completed
    assert len({r.id for r in done}) == len(done) == rep.n_requests
    for r in done:
        assert r.start_proc >= r.arrival - 1e-9 and r.finish > r.start_proc
    if name.startswith("static-"):
        cores = int(name.split("-")[1])
        horizon = max(r.arrival for r in done) + 60.0
        assert rep.core_seconds == pytest.approx(cores * horizon, rel=0.05)
    if name == "sponge":
        inst = server.pool[0].instance
        assert len({e.c_to for e in inst.resizes}) > 1
    if name == "fa2":
        for s in server.pool + server.backend.dead:
            if s.ready_at > 0:
                assert s.ready_at - s.alive_since >= 10.0 - 1e-9


def test_launcher_sim_mode_prints_the_reference_ratios():
    argv = ["--mode", "sim", "--duration", "60", "--seed", "3"]
    mine, ref = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(mine):
        out = launcher.main(argv)
    with contextlib.redirect_stdout(ref):
        jax_launcher.main(argv)
    assert mine.getvalue() == ref.getvalue()
    assert "reduction vs FA2" in mine.getvalue()
    assert set(out) == {p for p, _ in launcher.SIM_POLICIES}


# --------------------------------------------------------------------------
# the live backend on a toy table (``tests/test_api_parity.py``)
# --------------------------------------------------------------------------
C_SET = B_SET = (1, 2, 4)
DIM = 16
PARITY_PERF = dict(gamma=0.030, eps=0.010, delta=0.002, eta=0.004)


def _script(req_cls, n=60, rps=15.0, seed=0, payloads=True):
    rng = np.random.default_rng(seed)
    rng_pay = np.random.default_rng(seed + 1)
    out = []
    for i in range(n):
        ts = i / rps
        cl = float(rng.uniform(0.02, 0.25))
        req = req_cls.make(arrival=ts + cl, comm_latency=cl, slo=0.6)
        out.append((req, rng_pay.standard_normal(DIM).astype(np.float32))
                   if payloads else req)
    return out


def _torch_server(policy, clock="modeled", prior_rps=15.0):
    fns = api.toy_step_fns(C_SET, B_SET, dim=DIM, device="cpu")
    backend = api.TorchBackend(fns, api.pad_vectors,
                               perf_model.PerfModel(**PARITY_PERF),
                               clock=clock, c0=1)
    return api.SpongeServer(policy, backend, prior_rps=prior_rps)


def test_protocols_are_satisfied():
    perf = perf_model.PerfModel(**PARITY_PERF)
    assert isinstance(baselines.SpongePolicy(psc.SpongeScaler(perf)),
                      api.SchedulingPolicy)
    assert isinstance(baselines.FA2Policy(perf), api.SchedulingPolicy)
    assert isinstance(psc.SpongeScaler(perf), api.SchedulingPolicy)
    assert isinstance(api.SimBackend(perf, C_SET, B_SET),
                      api.ExecutionBackend)
    assert isinstance(_torch_server(None).backend, api.ExecutionBackend)


def test_torch_backend_modeled_equals_sim_backend():
    perf, jperf = perf_model.PerfModel(**PARITY_PERF), jpm.PerfModel(**PARITY_PERF)

    def sponge(mod_sc, mod_base, pm):
        return mod_base.SpongePolicy(mod_sc.SpongeScaler(
            pm, c_set=C_SET, b_set=B_SET))

    sim = api.make_sim_server(perf, sponge(psc, baselines, perf),
                              c_set=C_SET, b_set=B_SET, c0=1,
                              prior_rps=15.0, resize_penalty=0.0)
    jsim = japi.make_sim_server(jperf, sponge(jsc, jbase, jperf),
                                c_set=C_SET, b_set=B_SET, c0=1,
                                prior_rps=15.0, resize_penalty=0.0)
    live = _torch_server(sponge(psc, baselines, perf))
    r_sim = sim.run(_script(Request, payloads=False), horizon=8.0)
    r_jsim = jsim.run(_script(JaxRequest, payloads=False), horizon=8.0)
    r_live = live.run(_script(Request), horizon=8.0)
    d = [(t, x.c, x.b, x.feasible) for t, x in r_live.decisions]
    assert d == [(t, x.c, x.b, x.feasible) for t, x in r_sim.decisions]
    assert stream(r_sim.decisions) == stream(r_jsim.decisions)
    assert r_live.buckets == r_sim.buckets == r_jsim.buckets
    assert r_live.n_requests == r_sim.n_requests == 60
    assert r_live.backend == "torch"
    results = live.backend.results
    assert len(results) == 60
    assert all(it.result.shape == (DIM,) and it.result.dtype == np.float32
               for it in results)


def test_torch_backend_measured_clock_serves_everything():
    perf = perf_model.PerfModel(**PARITY_PERF)
    pol = baselines.SpongePolicy(psc.SpongeScaler(
        perf, c_set=C_SET, b_set=B_SET, adaptation_interval=0.5))
    srv = _torch_server(pol, clock="measured")
    report = srv.run(_script(Request, n=30), horizon=10.0)
    assert report.n_requests == 30
    assert len(srv.backend.measured) > 0
    assert len(srv.monitor.perf_residuals) == len(srv.backend.measured)


def test_fa2_multi_instance_on_live_backend():
    perf = perf_model.PerfModel(**PARITY_PERF)
    pol = baselines.FA2Policy(perf, slo=0.6, expected_rps=40.0,
                              cold_start=0.5, b_set=B_SET,
                              reconfig_interval=1.0)
    srv = _torch_server(pol, prior_rps=40.0)
    report = srv.run(_script(Request, n=80, rps=40.0), horizon=6.0)
    assert max(cores for _, cores in report.core_timeline) > 1
    assert all(s.instance.c == 1 for s in srv.pool + srv.backend.dead)
    assert report.n_requests == 80


def test_policy_registry():
    perf = perf_model.yolov5s_like()
    assert isinstance(api.make_policy("static-12", perf),
                      baselines.StaticPolicy)
    assert api.make_policy("static-12", perf).cores == 12
    assert api.make_policy("sponge", perf).scaler.perf is perf
    with pytest.raises(KeyError):
        api.make_policy("nope", perf_model.yolov5s_like())


@pytest.mark.parametrize("out", [
    torch.arange(12, dtype=torch.int32).reshape(3, 4),
    {"ids": torch.arange(6).reshape(3, 2), "n": 3},
    (torch.ones(3, 2), torch.zeros(3))])
def test_index_result_copies_once_and_indexes_rows(out):
    host = api._to_host(out)
    for i in range(3):
        row = api._index_result(host, i)
        ref = jax.tree.map(lambda a: np.asarray(a)[i] if hasattr(a, "shape")
                           and getattr(a, "ndim", 0) > 0 else a,
                           jax.tree.map(lambda t: t.numpy()
                                        if isinstance(t, torch.Tensor)
                                        else t, out))
        jax.tree.map(np.testing.assert_array_equal, row, ref)


# --------------------------------------------------------------------------
# the live table on the reduced models, with the reference's weights
# --------------------------------------------------------------------------
PROMPT, GEN = 8, 3


def _reference_weights(arch):
    jcfg = jax_get_config(arch)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    return jcfg, params_from_jax(tree, get_config(arch), device="cpu")


@pytest.mark.parametrize("arch,b_set", [(ARCH, (1, 2, 4)),
                                         ("rwkv6-1.6b-reduced", (4,)),
                                         ("zamba2-2.7b-reduced", (4,))])
def test_llm_step_fns_give_the_reference_ids(arch, b_set):
    jcfg, params = _reference_weights(arch)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    cfg = dataclasses.replace(get_config(arch), use_pallas_prefill=True,
                              use_pallas_decode=True)
    model = build_model(cfg, device="cpu")
    fns = api.build_llm_step_fns(model, params, (1, 2), b_set, PROMPT,
                                 gen_tokens=GEN)
    jfns = japi.build_llm_step_fns(jmodel, jparams, (1,), b_set, PROMPT,
                                   gen_tokens=GEN)
    assert fns[(1, b_set[-1])] is fns[(2, b_set[-1])]
    rng = np.random.default_rng(5)
    for b in b_set:
        tokens = rng.integers(0, cfg.vocab_size, (b, PROMPT)).astype(np.int32)
        ids = fns[(2, b)](tokens)
        assert ids.dtype == torch.int32 and ids.shape == (b, GEN)
        np.testing.assert_array_equal(ids.numpy(),
                                      np.asarray(jfns[(1, b)](tokens)))


@pytest.fixture(scope="module")
def live_runs():
    """Both packages' ``make_live_server`` on the modelled clock with the
    same fitted perf model and weights, serving ``run_live``'s arrivals."""
    perf = dict(gamma=0.004, eps=0.002, delta=0.003, eta=0.02)
    kw = dict(c_set=(1, 2, 4), b_set=(1, 2, 4), prompt_len=PROMPT,
              gen_tokens=GEN, clock="modeled", prior_rps=10.0, slo=1.0,
              expected_rps=10.0)
    jserver, jcfg = japi.make_live_server(ARCH, perf=jpm.PerfModel(**perf),
                                          **kw)
    jserver.backend.resize_penalty = 0.0
    _, params = _reference_weights(ARCH)
    server, cfg = api.make_live_server(ARCH, perf=perf_model.PerfModel(**perf),
                                       params=params, device="cpu", **kw)
    arrivals = launcher.live_arrivals(10.0, 3.0, 1.0, 200.0, PROMPT,
                                      cfg.vocab_size, seed=42)
    jarrivals = [(JaxRequest.make(arrival=r.arrival,
                                  comm_latency=r.comm_latency, slo=r.slo), p)
                 for r, p in arrivals]
    rep = server.run(arrivals, horizon=33.0)
    jrep = jserver.run(jarrivals, horizon=33.0)
    return (server, rep, arrivals), (jserver, jrep, jarrivals)


def test_live_arrivals_are_run_lives():
    trace = jax_trace(8, seed=42)
    rng = np.random.default_rng(42)
    mine = launcher.live_arrivals(10.0, 3.0, 1.0, 200.0, PROMPT, 1000, 42)
    assert len(mine) == 30
    for i, (r, prompt) in enumerate(mine):
        jr = JaxRequest.make(arrival=i / 10.0 + jax_comm_latency(
            200.0, trace, i / 10.0), comm_latency=jax_comm_latency(
            200.0, trace, i / 10.0), slo=1.0)
        assert (r.arrival, r.comm_latency, r.deadline) == \
            (jr.arrival, jr.comm_latency, jr.deadline)
        np.testing.assert_array_equal(
            prompt, rng.integers(0, 1000, PROMPT).astype(np.int32))


def test_live_server_decisions_and_buckets_equal_reference(live_runs):
    (server, rep, _), (jserver, jrep, _) = live_runs
    assert rep.decisions and stream(rep.decisions) == stream(jrep.decisions)
    assert rep.buckets == jrep.buckets
    for k in ("n_requests", "n_violations", "p50", "p99", "core_seconds"):
        assert rep[k] == jrep[k], k
    assert rep.n_requests == 30 and rep.backend == "torch"
    assert server.backend.c_set == jserver.backend.c_set == (1, 2, 4)


def test_live_server_ids_equal_reference(live_runs):
    (server, _, arrivals), (jserver, _, jarrivals) = live_runs
    ids = {it.req.arrival: it.result for it in server.backend.results}
    jids = {it.req.arrival: it.result for it in jserver.backend.results}
    assert len(ids) == len(arrivals) == len(jids) == len(jarrivals)
    for t, row in ids.items():
        assert row.dtype == np.int32 and row.shape == (GEN,)
        np.testing.assert_array_equal(row, jids[t])


def test_serving_engine_run_script():
    """``tests/test_system.py::test_live_engine_serves_with_vertical_
    scaling`` on the port (the deprecated shim warns on import)."""
    with pytest.warns(DeprecationWarning):
        import repro_torch.serving.engine as engine
        importlib.reload(engine)
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    c_set, b_set = (1, 2, 4), (1, 2, 4)
    fns = engine.build_llm_step_fns(model, params, c_set, b_set, 16,
                                    gen_tokens=4)
    perf = perf_model.PerfModel(gamma=0.05, eps=0.01, delta=0.01, eta=0.02)
    sc = psc.SpongeScaler(perf, c_set=c_set, b_set=b_set,
                          adaptation_interval=0.25)
    eng = engine.ServingEngine(fns, sc, engine.pad_tokens, prior_rps=20)
    eng.warmup(np.ones(16, np.int32))
    rng = np.random.default_rng(0)
    arrivals = []
    for i in range(40):
        req = Request.make(arrival=i * 0.04, comm_latency=0.02, slo=5.0)
        arrivals.append((req, rng.integers(0, cfg.vocab_size,
                                           16).astype(np.int32)))
    res = eng.run_script(arrivals)
    assert res["n"] == 40
    assert res["violation_rate"] < 0.5
    assert len(eng.decision_log) >= 2
    assert eng.results[0].result.shape == (4,)
    eng.apply(Decision(c=3, b=2), now=100.0)
    assert (eng.c, eng.b) == (4, 2)


@pytest.mark.parametrize("policy", ["sponge", "fa2"])
def test_launcher_live_mode_on_cpu(policy, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        res = launcher.main(["--mode", "live", "--device", "cpu",
                             "--arch", ARCH, "--rps", "10",
                             "--duration", "2", "--slo", "3",
                             "--prompt-len", "8", "--gen-tokens", "2",
                             "--policy", policy])
    assert res["n"] == 20 and res["decisions"] >= 1
    out = capsys.readouterr().out
    assert "calibrated perf model: gamma=" in out and '"p99"' in out
