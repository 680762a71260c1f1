"""The port's control plane and token serving slice against the JAX package.

The control-plane modules are copies of the reference's NumPy code, so
the same inputs must give the same decisions, float for float.  The
slice test serves ``llm-chat`` through both packages' ``ScenarioRunner``
with the same weights and the same ``TokenCostModel`` on the modelled
clock and demands equal decisions, buckets, timings and token ids.
Everything here runs on the CPU.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.cost_model import TokenCostModel as JaxCost
from repro.core.queueing import EDFQueue as JaxQueue
from repro.core.slo import Request as JaxRequest
from repro.core.solver import TokenMemoizedSolver as JaxMemo
from repro.core.solver import TokenSolverTable as JaxTable
from repro.core.solver import solve_token_bruteforce as jax_bruteforce
from repro.models import build_model as jax_build
from repro.network.latency import comm_latency_many as jax_comm
from repro.network.traces import synth_4g_trace as jax_trace
from repro.serving import scenarios as jax_scenarios
from repro.serving import token_backend as jax_tb
from repro_torch.configs import get_config
from repro_torch.core.cost_model import TokenCostModel
from repro_torch.core.queueing import EDFQueue
from repro_torch.core.slo import Request
from repro_torch.core.solver import (TokenMemoizedSolver, TokenSolverTable,
                                     solve_token_bruteforce)
from repro_torch.core.vertical import TimedExecutor
from repro_torch.launch import serve as launcher
from repro_torch.models import params_from_jax
from repro_torch.network.latency import comm_latency_many
from repro_torch.network.traces import synth_4g_trace
from repro_torch.serving import api as serving_api
from repro_torch.serving import scenarios
from repro_torch.serving import token_backend as tb

REPO = Path(__file__).resolve().parents[1]
ARCH = "smollm-135m-reduced"


def decision_key(d):
    """A Decision's fields without its wall-clock solver time."""
    out = dataclasses.asdict(d)
    out.pop("solver_time")
    return out


# --------------------------------------------------------------------------
# control plane copies: the same inputs give the same answers
# --------------------------------------------------------------------------
def test_cost_model_matches_reference():
    ref, port = JaxCost.smollm_like(40.0, 12.0), TokenCostModel.smollm_like(40.0, 12.0)
    np.testing.assert_equal(dataclasses.asdict(port), dataclasses.asdict(ref))
    for c in (1, 3, 16):
        for n in (1, 7, 300):
            assert port.prefill_latency(c, n) == ref.prefill_latency(c, n)
            assert port.decode_latency(c, n) == ref.decode_latency(c, n)
            assert port.throughput(n, c) == ref.throughput(n, c)
    rng = np.random.default_rng(0)
    pre = [(float(t), float(c), float(rng.uniform(0.001, 0.1)))
           for t in (16, 64, 256) for c in (1, 2, 4)]
    dec = [(float(s), float(c), float(rng.uniform(0.001, 0.05)))
           for s in (1, 2, 4) for c in (1, 2, 4)]
    np.testing.assert_equal(dataclasses.asdict(TokenCostModel.fit(pre, dec)),
                            dataclasses.asdict(JaxCost.fit(pre, dec)))


@pytest.mark.parametrize("seed", range(3))
def test_token_solvers_match_reference(seed):
    rng = np.random.default_rng(seed)
    cost, jcost = TokenCostModel.smollm_like(), JaxCost.smollm_like()
    table, jtable = TokenSolverTable(cost), JaxTable(jcost)
    memo = TokenMemoizedSolver(cost, budget_quantum=0.02, lam_quantum=0.5,
                               token_quantum=16)
    jmemo = JaxMemo(jcost, budget_quantum=0.02, lam_quantum=0.5,
                    token_quantum=16)
    for _ in range(60):
        n = int(rng.integers(0, 24))
        rem = np.sort(rng.uniform(0, 2.0, n))
        toks = rng.integers(1, 400, n).astype(np.float64)
        lam = float(rng.uniform(0, 60))
        kw = dict(initial_wait=float(rng.uniform(0, 0.3)),
                  tbt_budget=float(rng.choice([np.inf, 0.02, 0.05, 0.2])),
                  active_slots=int(rng.integers(0, 8)))
        assert decision_key(solve_token_bruteforce(rem, toks, lam, cost, **kw)) \
            == decision_key(jax_bruteforce(rem, toks, lam, jcost, **kw))
        assert decision_key(table.solve(rem, toks, lam, **kw)) \
            == decision_key(jtable.solve(rem, toks, lam, **kw))
        assert decision_key(memo.solve(rem, toks, lam, **kw)) \
            == decision_key(jmemo.solve(rem, toks, lam, **kw))
    assert (memo.hits, memo.misses) == (jmemo.hits, jmemo.misses)


def test_edf_queue_token_snapshot_matches_reference():
    rng = np.random.default_rng(4)
    q, jq = EDFQueue(), JaxQueue()
    rows = [(float(rng.uniform(0, 5)), float(rng.uniform(0.2, 2)),
             int(rng.integers(1, 300)), float(rng.choice([0.05, 0.08])))
            for _ in range(30)]
    reqs, jreqs = [], []
    for arrival, slo, prompt, tbt in rows:
        reqs.append(Request.make(arrival=arrival, comm_latency=0.01, slo=slo,
                                 prompt_tokens=prompt, tbt_slo=tbt))
        jreqs.append(JaxRequest.make(arrival=arrival, comm_latency=0.01,
                                     slo=slo, prompt_tokens=prompt,
                                     tbt_slo=tbt))
    for r, jr in zip(reqs, jreqs):
        q.push(r)
        jq.push(jr)
    for i in (3, 7):
        q.cancel(reqs[i].id)
        jq.cancel(jreqs[i].id)
    q.update_deadline(reqs[5].id, 0.1)
    jq.update_deadline(jreqs[5].id, 0.1)
    for a, b in zip(q.token_snapshot(2.0), jq.token_snapshot(2.0)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert [r.arrival for r in q.pop_batch(6)] == \
        [r.arrival for r in jq.pop_batch(6)]


def test_network_trace_and_latency_match_reference():
    trace, jtrace = synth_4g_trace(90, seed=7), jax_trace(90, seed=7)
    np.testing.assert_array_equal(trace.mbps, jtrace.mbps)
    rng = np.random.default_rng(5)
    sizes = rng.uniform(1, 300, 50)
    send = np.sort(rng.uniform(0, 80, 50))
    np.testing.assert_array_equal(comm_latency_many(sizes, trace, send),
                                  jax_comm(sizes, jtrace, send))


@pytest.mark.parametrize("requests,seed", [(8, 3), (48, 0), (500, 11)])
def test_llm_chat_scenario_matches_reference(requests, seed):
    batch, meta = scenarios.build_scenario("llm-chat", requests=requests,
                                           seed=seed)
    jbatch, jmeta = jax_scenarios.build_scenario("llm-chat",
                                                 requests=requests, seed=seed)
    for f in dataclasses.fields(jbatch):
        a, b = getattr(batch, f.name), getattr(jbatch, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_equal(dataclasses.asdict(meta["cost"]),
                            dataclasses.asdict(jmeta["cost"]))
    for k in ("slo", "expected_rps", "tbt", "tick", "duration", "rps"):
        assert meta[k] == jmeta[k], k


@pytest.mark.parametrize("payloads,b,n", [
    ([np.arange(1, 4), np.arange(5, 15)], 4, 8),   # short, long, batch pad
    ([None, np.arange(3)], 2, 5),                  # a missing payload
    ([np.arange(10)], 1, 10),
])
def test_pad_prompts_matches_reference(payloads, b, n):
    np.testing.assert_array_equal(tb.pad_prompts(payloads, b, n),
                                  jax_tb.pad_prompts(payloads, b, n))


def test_timed_executor_records_each_call():
    ex = TimedExecutor({(1, 2): lambda x: x + 1})
    assert ex(1, 2, 41) == 42
    (t0, c, b, dt), = ex.calls
    assert (c, b) == (1, 2) and dt >= 0.0


# --------------------------------------------------------------------------
# the slice: both packages serve llm-chat to the same result
# --------------------------------------------------------------------------
SLICE = dict(requests=8, seed=3, prompt_len=8, max_decode=3)


def _jax_arrivals(batch, vocab_size):
    """The reference's ``run_token_jax_scenario`` arrival loop."""
    rng = np.random.default_rng(SLICE["seed"])
    out = []
    for r in batch.head(SLICE["requests"]).to_requests():
        r = JaxRequest.make(arrival=r.arrival, comm_latency=r.comm_latency,
                            slo=r.slo, size_kb=r.size_kb,
                            prompt_tokens=min(r.prompt_tokens, SLICE["prompt_len"]),
                            decode_tokens=min(r.decode_tokens, SLICE["max_decode"]),
                            tbt_slo=r.tbt_slo)
        out.append((r, rng.integers(0, vocab_size, r.prompt_tokens)
                    .astype(np.int32)))
    return out


@pytest.fixture(scope="module", params=[ARCH, "rwkv6-1.6b-reduced",
                                        "zamba2-2.7b-reduced",
                                        "gemma-2b-reduced",
                                        "h2o-danube-1.8b-reduced"])
def slice_runs(request):
    arch = request.param
    n, seed = SLICE["requests"], SLICE["seed"]
    pl, md = SLICE["prompt_len"], SLICE["max_decode"]
    # reference: its own stack, kernel routes on (Pallas in interpret mode)
    jbatch, jmeta = jax_scenarios.build_scenario("llm-chat", requests=n,
                                                 seed=seed)
    jrunner, jbackend, jcfg, _ = jax_tb.make_token_live_server(
        arch, prompt_len=pl, max_decode=md, clock="modeled",
        prior_rps=jmeta["expected_rps"], tick=jmeta["tick"],
        cost=jmeta["cost"])
    jarr = _jax_arrivals(jbatch, jcfg.vocab_size)
    jrep = jrunner.run(jarr)
    # the port, on the same weights (make_token_live_server inits key(0))
    tree = jax.tree.map(np.asarray,
                        jax_build(jcfg).init(jax.random.key(0)))
    params = params_from_jax(tree, get_config(arch), device="cpu")
    batch, meta = scenarios.build_scenario("llm-chat", requests=n, seed=seed)
    runner, backend, cfg, _ = tb.make_token_live_server(
        arch, prompt_len=pl, max_decode=md, clock="modeled",
        prior_rps=meta["expected_rps"], tick=meta["tick"], cost=meta["cost"],
        params=params, device="cpu")
    arr = tb.scenario_arrivals(batch, n, seed, pl, md, cfg.vocab_size)
    rep = runner.run(arr)
    return (rep, backend, arr), (jrep, jbackend, jarr)


def test_slice_decisions_and_buckets_equal(slice_runs):
    (rep, backend, _), (jrep, jbackend, _) = slice_runs
    assert rep.decisions and len(rep.decisions) == len(jrep.decisions)
    for (t, d), (jt, jd) in zip(rep.decisions, jrep.decisions):
        assert t == jt and decision_key(d) == decision_key(jd)
    assert rep.buckets == jrep.buckets and rep.buckets
    assert [call[1:3] for call in backend.pre_table.calls] == \
        [call[1:3] for call in jbackend.pre_table.calls]


def test_slice_timings_equal(slice_runs):
    (rep, _, arr), (jrep, _, jarr) = slice_runs
    assert len(arr) == len(jarr)
    for (r, _), (jr, _) in zip(arr, jarr):
        assert (r.arrival, r.deadline, r.prompt_tokens, r.decode_tokens) == \
            (jr.arrival, jr.deadline, jr.prompt_tokens, jr.decode_tokens)
        assert (r.first_token, r.finish, r.tbt_violations) == \
            (jr.first_token, jr.finish, jr.tbt_violations)
    for k in ("n_requests", "n_violations", "tokens_served", "ttft_p50",
              "ttft_p99", "tbt_violation_rate", "p99", "core_seconds"):
        assert rep[k] == jrep[k], k
    assert rep.n_requests > 0 and rep.tokens_served > 0


def test_slice_generated_ids_equal(slice_runs):
    (rep, backend, arr), (jrep, jbackend, jarr) = slice_runs
    ids = [backend.generated.get(r.id) for r, _ in arr]
    jids = [jbackend.generated.get(r.id) for r, _ in jarr]
    assert ids == jids
    assert sum(len(x) for x in ids if x) == backend.tokens_served \
        == jbackend.tokens_served == rep.tokens_served


def test_run_token_scenario_on_cpu():
    rep, stats = tb.run_token_scenario("llm-chat", arch=ARCH, requests=6,
                                       seed=1, prompt_len=8, max_decode=2,
                                       device="cpu")
    assert rep.n_requests > 0
    assert stats["tokens_executed"] == rep.tokens_served > 0
    assert np.isfinite(rep.ttft_p99)
    assert stats["engine"] == "token-torch" and stats["device"] == "cpu"
    assert len(stats["generated"]) == rep.n_requests


@pytest.mark.parametrize("arch", [ARCH, "rwkv6-1.6b-reduced",
                                  "zamba2-2.7b-reduced", "smollm-360m-reduced",
                                  "gemma-2b-reduced",
                                  "h2o-danube-1.8b-reduced"])
def test_launcher_token_branch_on_cpu(arch, capsys):
    out = launcher.main(["--scenario", "llm-chat", "--device", "cpu",
                         "--arch", arch, "--requests", "4",
                         "--prompt-len", "8", "--gen-tokens", "2",
                         "--seed", "2"])
    assert out["engine"] == "token-torch" and out["n"] > 0
    assert out["tokens_served"] > 0 and '"ttft_p99"' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launcher.main(["--scenario", "llm-chat", "--device", "cpu",
                       "--policy", "fa2"])


# --------------------------------------------------------------------------
# the port's boundaries
# --------------------------------------------------------------------------
def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    for f in files:
        bad = {m for m in _imported_roots(f)
               if m in ("jax", "jaxlib", "repro", "flax", "optax")}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_port_lints_clean():
    from tools.spongelint import lint_paths
    assert lint_paths([REPO / "src" / "repro_torch"]) == []


@pytest.mark.parametrize("entry", ["make_token_live_server",
                                   "run_token_scenario", "launcher",
                                   "make_live_server", "launcher-live",
                                   "toy_step_fns"])
def test_entry_points_without_a_card_raise(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "make_token_live_server":
            tb.make_token_live_server(ARCH, prompt_len=8, max_decode=2)
        elif entry == "run_token_scenario":
            tb.run_token_scenario("llm-chat", arch=ARCH, requests=2)
        elif entry == "make_live_server":
            serving_api.make_live_server(ARCH, prompt_len=8, gen_tokens=2)
        elif entry == "launcher-live":
            launcher.main(["--mode", "live", "--duration", "1"])
        elif entry == "toy_step_fns":
            serving_api.toy_step_fns((1,), (1,))
        else:
            launcher.main(["--scenario", "llm-chat", "--requests", "2"])
