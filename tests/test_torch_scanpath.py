"""The port's decode-stream scan engine against the JAX package.

``serving/scanpath.py``'s contract is **backend parity**: the integer-µs
step must give bit-identical decision streams, first-token / finish
columns, per-request TBT-violation counts, core-seconds and step counts
on every backend.  Here the port's ``backend="torch"`` (``device="cpu"``:
the same ops the card runs, eagerly) and ``backend="numpy"`` (the plain
version) are held to the reference's ``backend="jax"`` (``lax.scan``
under ``jax.jit`` on the CPU) and ``backend="numpy"`` on the same
workloads, the cases of ``tests/test_scanpath.py``.  The card's own
parity (captured chunks replayed) is in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.scaler import SpongeScaler as JSpongeScaler
from repro.serving import scanpath as jscanpath
from repro.serving import scenarios as jax_scenarios
from repro_torch.core.baselines import SpongePolicy
from repro_torch.core.scaler import SpongeScaler
from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
from repro_torch.serving.fastpath import TokenFastSimRunner
from repro_torch.serving.scanpath import ScanDecodeEngine, make_sponge_decide
from repro_torch.serving.scenarios import build_scenario

KEYS = ("first_tok", "finish", "tbt_violations", "decisions",
        "core_seconds", "steps", "n_served")


def _workload(duration=40, seed=3, jax=False):
    build = (jax_scenarios.build_scenario if jax else build_scenario)
    batch, meta = build("llm-chat", duration=duration, seed=seed)
    return batch, meta["cost"]


def _assert_parity(a, b):
    assert a["decisions"] == b["decisions"]
    assert np.array_equal(a["first_tok"], b["first_tok"], equal_nan=True)
    assert np.array_equal(a["finish"], b["finish"], equal_nan=True)
    assert np.array_equal(a["tbt_violations"], b["tbt_violations"])
    assert a["core_seconds"] == b["core_seconds"]
    assert a["steps"] == b["steps"]
    assert a["n_served"] == b["n_served"]


def _run_all(engine_kw, duration, seed, horizon=None, decide=None):
    """The same engine on the port's torch (CPU) and NumPy backends and
    on the reference's JAX and NumPy backends; ``decide(scaler_cls,
    cost)`` builds each side's chunk-boundary hook."""
    batch, cost = _workload(duration, seed)
    jbatch, jcost = _workload(duration, seed, jax=True)

    def engine(mod, c, scaler_cls):
        kw = dict(engine_kw)
        if decide is not None:
            kw["decide"] = decide(mod, scaler_cls, c)
        return mod.ScanDecodeEngine(c, **kw)

    from repro_torch.serving import scanpath
    out = {
        "torch": engine(scanpath, cost, SpongeScaler).run(
            batch, horizon=horizon, backend="torch", device="cpu"),
        "numpy": engine(scanpath, cost, SpongeScaler).run(
            batch, horizon=horizon, backend="numpy"),
        "jax": engine(jscanpath, jcost, JSpongeScaler).run(
            jbatch, horizon=horizon, backend="jax"),
        "jax-numpy": engine(jscanpath, jcost, JSpongeScaler).run(
            jbatch, horizon=horizon, backend="numpy"),
    }
    assert [r["backend"] for r in out.values()] == ["torch", "numpy",
                                                    "jax", "numpy"]
    for r in list(out.values())[1:]:
        _assert_parity(out["torch"], r)
    return out


def _sponge_decide(mod, scaler_cls, cost):
    return mod.make_sponge_decide(scaler_cls(cost), cost, DEFAULT_C,
                                  DEFAULT_B)


@pytest.mark.parametrize("chunk", [16, 64])
def test_torch_numpy_jax_parity_static(chunk):
    """Static (c0, b0) knobs, two chunk sizes."""
    out = _run_all(dict(c0=8, b0=8, chunk_steps=chunk), 40, 3)
    assert out["torch"]["n_served"] > 0 and out["torch"]["steps"] > 0


def test_parity_dynamic_decide():
    """Chunk-boundary (c, b) decisions via make_sponge_decide: the knobs
    change across chunks (written in place, one chunk function) and
    every backend still agrees bit for bit."""
    out = _run_all(dict(c0=4, b0=4, chunk_steps=32), 30, 7,
                   decide=_sponge_decide)
    assert len({(c, bb) for _, c, bb in out["torch"]["decisions"]}) > 1, \
        "decide hook never changed the knobs: test is vacuous"


def test_parity_prefill_allowance():
    """The break-at-first-overflow prefill-prefix semantics match across
    backends when the allowance actually bites."""
    batch, _ = _workload(25, 11)
    allow = int(np.asarray(batch.prompt_tokens).mean() * 2)
    out = _run_all(dict(c0=8, b0=16, chunk_steps=32,
                        prefill_allowance=allow), 25, 11)
    ref = _run_all(dict(c0=8, b0=16, chunk_steps=32), 25, 11)
    assert not np.array_equal(out["torch"]["first_tok"],
                              ref["torch"]["first_tok"], equal_nan=True), \
        "the allowance never bit: test is vacuous"


def test_parity_with_a_horizon_that_cuts_the_run():
    """A horizon inside the workload: chunks stop at the first boundary
    past it and core-seconds are clamped to it on every backend."""
    out = _run_all(dict(c0=2, b0=4, chunk_steps=16), 30, 5, horizon=12.0)
    assert out["torch"]["n_served"] < len(_workload(30, 5)[0])
    assert out["torch"]["core_seconds"] <= 2 * 12.0


def test_numpy_backend_standalone():
    """The plain version serves the workload end to end."""
    batch, cost = _workload(duration=30, seed=5)
    out = ScanDecodeEngine(cost, c0=8, b0=8).run(batch, backend="numpy")
    assert out["backend"] == "numpy"
    assert out["n_served"] == int(np.isfinite(out["finish"]).sum()) > 0
    served = np.isfinite(out["finish"])
    assert np.all(out["first_tok"][served] <= out["finish"][served])
    assert np.all(out["first_tok"][served]
                  >= np.asarray(batch.arrival)[served])
    assert out["core_seconds"] > 0.0


def test_torch_two_runs_identical_on_kept_buffers():
    """A second run of the same engine on a same-size workload reuses
    the chunk's static buffers (on the card: replays the captured
    graph) and gives the same result; a different size rebuilds them."""
    batch, cost = _workload(duration=30, seed=9)
    eng = ScanDecodeEngine(cost, c0=8, b0=8)
    r1 = eng.run(batch, backend="torch", device="cpu")
    chunk = eng._torch_chunk
    r2 = eng.run(batch, backend="torch", device="cpu")
    assert eng._torch_chunk is chunk
    for k in KEYS:
        if k in ("first_tok", "finish"):
            assert np.array_equal(r1[k], r2[k], equal_nan=True)
        else:
            assert np.array_equal(r1[k], r2[k]), k
    assert eng.replays == 0 and eng.chunks == len(r2["decisions"])
    small = batch.head(len(batch) // 2)
    eng.run(small, backend="torch", device="cpu")
    assert eng._torch_chunk is not chunk
    _assert_parity(eng.run(small, backend="torch", device="cpu"),
                   ScanDecodeEngine(cost, c0=8, b0=8).run(
                       small, backend="numpy"))


def test_empty_workload():
    batch, cost = _workload(duration=10, seed=1)
    empty = batch.head(0)
    for backend in ("torch", "numpy"):
        out = ScanDecodeEngine(cost).run(empty, backend=backend,
                                         device="cpu")
        assert out["n_served"] == out["steps"] == 0
        assert out["decisions"] == [] and out["core_seconds"] == 0.0


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_card_backends_without_a_card_raise(backend, monkeypatch):
    """``auto`` means the card, and neither it nor ``torch`` with no
    device falls back to NumPy when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch, cost = _workload(duration=10, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScanDecodeEngine(cost, c0=8, b0=8).run(batch, backend=backend)


def test_auto_backend_resolves_to_torch():
    batch, cost = _workload(duration=15, seed=2)
    out = ScanDecodeEngine(cost, c0=8, b0=8).run(batch, backend="auto",
                                                 device="cpu")
    assert out["backend"] == "torch"


@pytest.mark.parametrize("backend", ["jax", "cuda-graph"])
def test_unknown_backends_refused(backend):
    batch, cost = _workload(duration=10, seed=1)
    with pytest.raises(ValueError, match="backend"):
        ScanDecodeEngine(cost, c0=8, b0=8).run(batch, backend=backend)


def test_horizon_overflow_rejected():
    """int32-µs time: horizons at/over 2^31 µs must refuse, not wrap."""
    batch, cost = _workload(duration=10, seed=1)
    eng = ScanDecodeEngine(cost, c0=8, b0=8)
    for backend in ("torch", "numpy"):
        with pytest.raises(ValueError, match="2147"):
            eng.run(batch, horizon=2200.0, backend=backend, device="cpu")


def test_coefficients_and_decide_equal_reference():
    from repro_torch.serving.scanpath import _coefficients
    _, cost = _workload(duration=10, seed=1)
    _, jcost = _workload(duration=10, seed=1, jax=True)
    for c in DEFAULT_C:
        assert _coefficients(cost, c) == jscanpath._coefficients(jcost, c)
    mine = make_sponge_decide(SpongeScaler(cost), cost, DEFAULT_C,
                              DEFAULT_B)
    ref = jscanpath.make_sponge_decide(JSpongeScaler(jcost), jcost,
                                       DEFAULT_C, DEFAULT_B)
    for waiting in range(0, 80, 7):
        for active in (0, 3, 16):
            assert mine(1.0, waiting, active) == ref(1.0, waiting, active)


def test_scan_engine_adapter():
    """TokenFastSimRunner.scan_engine() hands its cost model and current
    allocation to a ScanDecodeEngine."""
    batch, cost = _workload(duration=20, seed=4)
    runner = TokenFastSimRunner(SpongePolicy(SpongeScaler(cost)), cost,
                                DEFAULT_C, DEFAULT_B, c0=8)
    eng = runner.scan_engine(chunk_steps=32)
    assert eng.cost is cost
    assert eng.c0 == 8 and eng.b0 == DEFAULT_B[-1] and eng.chunk_steps == 32
    out = eng.run(batch, backend="torch", device="cpu")
    assert out["n_served"] > 0
    _assert_parity(out, eng.run(batch, backend="numpy"))
