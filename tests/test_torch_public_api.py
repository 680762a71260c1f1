"""Public-API snapshot of the PyTorch port: ``tests/test_public_api.py``
with ``repro_torch`` for ``repro`` and the JAX-bound names swapped for
their torch twins (``TorchBackend`` for ``JaxBackend``; the solver's
``TPU_B`` / ``TPU_C`` are left out of the port by design).

The exported-name sets below are the contract other code programs
against.  If a change alters one of these sets, this test fails and the
snapshot must be updated with it, so that a re-export cannot appear or
vanish unseen.  Beside the reference's checks: the port's ``core``,
``network`` and ``kernels`` package surfaces, and that importing them
builds no kernel and imports no deprecated shim, no JAX and nothing of
the reference.
"""
import json
import os
import subprocess
import sys
import warnings

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

SERVING_EXPORTS = {
    "ExactSession", "FastSession", "FleetSession", "TorchBackend",
    "RequestBatch", "RunReport", "ScenarioRunner", "SessionTranscript",
    "SimBackend", "SpongeServer", "SpongeSession", "TenantPool",
    "TenantSpec", "TokenFastSession", "WorkloadGenerator",
    "drive_session_events", "make_live_server", "make_policy",
    "make_sim_server", "replay_transcript", "round_up_c",
}

SOLVER_EXPORTS = {
    "DEFAULT_B", "DEFAULT_C", "DEFAULT_N", "JointMemoizedSolver",
    "JointSolverTable", "MemoizedSolver", "MultiModelMemoizedSolver",
    "MultiModelSolverTable", "SolverTable", "TokenMemoizedSolver",
    "TokenSolverTable", "solve_bruteforce", "solve_joint_bruteforce",
    "solve_multimodel_bruteforce", "solve_pruned",
    "solve_token_bruteforce",
}

DEGRADATION_EXPORTS = {
    "DEFAULT_LADDER_ARCHS", "FULL_LADDER_ARCHS", "ModelLadder",
    "ModelRung", "default_ladder", "fit_rung_cost", "resolve_ladder",
}

UNCERTAINTY_EXPORTS = {
    "EmpiricalLengths", "LengthDistribution", "LengthPredictor",
    "LognormalLengths", "MixtureLengths", "PointMass",
    "UncertaintyConfig",
}

CORE_EXPORTS = {
    "Request", "Decision", "PerfModel", "solve_bruteforce", "solve_pruned",
    "EDFQueue", "DynamicBatcher", "SpongeScaler", "VerticalScaledInstance",
}

NETWORK_EXPORTS = {"BandwidthTrace", "synth_4g_trace", "comm_latency"}

KERNEL_EXPORTS = {
    "kernels": {"decode_attention", "rwkv6_scan", "ssd_scan",
                "swa_prefill_attention", "add_rms_norm", "rope_kv_write",
                "glu_gate", "mamba2_conv_step", "mamba2_gate_norm",
                "decode_gemm"},
    "kernels.add_rms_norm": {"add_rms_norm"},
    "kernels.decode_attention": {"decode_attention"},
    "kernels.decode_gemm": {"decode_gemm"},
    "kernels.glu_gate": {"glu_gate"},
    "kernels.mamba2_conv_step": {"mamba2_conv_step"},
    "kernels.mamba2_gate_norm": {"mamba2_gate_norm"},
    "kernels.rope_kv_write": {"rope_kv_write"},
    "kernels.rwkv6_scan": {"rwkv6_scan"},
    "kernels.ssd_scan": {"ssd_scan"},
    "kernels.swa_prefill": {"swa_prefill_attention"},
}


def _public_names(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n in vars(mod)
            if not n.startswith("_") and not _is_module(vars(mod)[n])}


def _is_module(obj) -> bool:
    import types
    return isinstance(obj, types.ModuleType)


def test_serving_public_surface():
    import repro_torch.serving as serving
    assert _public_names(serving) == SERVING_EXPORTS


def test_uncertainty_public_surface():
    import repro_torch.core.uncertainty as uncertainty
    assert _public_names(uncertainty) == UNCERTAINTY_EXPORTS


def test_solver_public_surface():
    import repro_torch.core.solver as solver
    names = {n for n in _public_names(solver)
             if n == n.upper() or n[:1].isupper() or n.startswith("solve")}
    assert names >= SOLVER_EXPORTS, (
        f"missing from repro_torch.core.solver: {SOLVER_EXPORTS - names}")


def test_degradation_public_surface():
    import repro_torch.core.degradation as degradation
    names = {n for n in _public_names(degradation)
             if n == n.upper() or n[:1].isupper()
             or n in ("default_ladder", "fit_rung_cost",
                      "resolve_ladder")}
    assert names >= DEGRADATION_EXPORTS, (
        "missing from repro_torch.core.degradation: "
        f"{DEGRADATION_EXPORTS - names}")


def test_core_and_network_public_surfaces():
    import repro_torch.core as core
    import repro_torch.network as network
    assert _public_names(core) == CORE_EXPORTS
    assert _public_names(network) == NETWORK_EXPORTS


@pytest.mark.parametrize("name", sorted(KERNEL_EXPORTS))
def test_kernel_package_surfaces(name):
    import importlib
    mod = importlib.import_module("repro_torch." + name)
    assert _public_names(mod) == KERNEL_EXPORTS[name]
    for fn in KERNEL_EXPORTS[name]:
        assert callable(getattr(mod, fn))


def test_surfaces_import_no_shim_no_jax_and_build_nothing():
    """In a fresh Python: the package surfaces import with warnings as
    errors, load no deprecated shim, no JAX and nothing of the
    reference, and leave every kernel unbuilt (the build happens at a
    kernel's first launch)."""
    script = r"""
import json, sys, warnings
warnings.simplefilter("error", DeprecationWarning)
import repro_torch.serving, repro_torch.core, repro_torch.network
import repro_torch.kernels
from repro_torch.kernels import build
print(json.dumps({
    "shims": sorted(m for m in ("repro_torch.serving.engine",
                                "repro_torch.serving.simulator",
                                "repro_torch.core.multidim")
                    if m in sys.modules),
    "foreign": sorted(m for m in sys.modules if m == "jax"
                      or m.startswith("jax.") or m == "repro"
                      or m.startswith("repro.")),
    "loaded": sorted(build._loaded)}))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "shims": [], "foreign": [], "loaded": []}


def test_serving_no_longer_reexports_shims():
    """The shim names are not on the package surface and only reachable
    through their warning modules."""
    import repro_torch.serving as serving
    for name in ("ClusterSimulator", "Server", "simulate",
                 "ServingEngine"):
        assert not hasattr(serving, name), name


def test_shim_modules_warn_on_import():
    import importlib
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro_torch.serving.simulator as sim_shim
        import repro_torch.serving.engine as eng_shim
        import repro_torch.core.multidim as multidim_shim
    for shim in (sim_shim, eng_shim, multidim_shim):
        with pytest.warns(DeprecationWarning):
            importlib.reload(shim)


def test_multidim_no_longer_patches_spongescaler():
    """The deprecated multidim module must not mutate ``SpongeScaler``
    at import time."""
    import importlib
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro_torch.core.multidim as multidim_shim
        importlib.reload(multidim_shim)
    from repro_torch.core.scaler import SpongeScaler
    assert not hasattr(SpongeScaler, "decide_shared")


def test_shims_still_functional_behind_the_warning():
    """Deprecated != broken: the historical constructor signatures keep
    working."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serving.simulator import (  # noqa
            ClusterSimulator, simulate)
    assert callable(simulate) and callable(ClusterSimulator)
