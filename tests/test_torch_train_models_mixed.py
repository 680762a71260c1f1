"""The port's training path against the JAX package's, on the CPU: the
MoE stacks (kimi-k2's ``attn+moe`` groups; deepseek-v3's MLA, MoE and
depth-1 MTP head), Qwen2-VL (the patch prefix, M-RoPE, the loss over the
text positions only) and whisper (the encoder, cross-attention).  The
helpers, checks and tolerances are those of
``tests/test_torch_train_models.py`` (its docstring says why each), and
so is its autouse fixture of one intra-op thread per test.
"""
import numpy as np
import pytest
import torch

from test_torch_train_models import (  # noqa: F401  (an autouse fixture)
    check_loss_and_grads, check_remat, check_train_step, configs,
    one_torch_thread, port, reference)
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.data import make_batch

ARCHS = ("kimi-k2-1t-a32b", "deepseek-v3-671b", "qwen2-vl-2b",
         "whisper-large-v3")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(arch):
    check_remat(arch)


def test_mtp_loss_present():
    """deepseek-v3's depth-1 MTP term is in the step's metrics, finite,
    and the reference's."""
    cfg, _ = configs("deepseek-v3-671b")
    assert cfg.mtp_depth == 1
    model, params = port("deepseek-v3-671b")
    oc = topt.OptConfig()
    state = {"params": params, "opt": topt.adamw_init(params, oc)}
    _, metrics = tloop.make_train_step(model, oc)(
        state, make_batch(cfg, 2, 12, 0))
    assert "mtp_ce" in metrics and np.isfinite(float(metrics["mtp_ce"]))
    np.testing.assert_allclose(
        float(metrics["mtp_ce"]),
        float(reference("deepseek-v3-671b")["step_metrics"]["mtp_ce"]),
        rtol=1e-6)


def test_router_bias_gets_a_zero_gradient():
    """The router bias only steers the top-k: no gradient reaches it,
    in the reference (``jax.grad`` gives zeros) or in the port."""
    ref = reference("kimi-k2-1t-a32b")
    assert not np.any(ref["grads"]["groups"][1]["moe"]["router_bias"])
    model, params = port("kimi-k2-1t-a32b")
    oc = topt.OptConfig()
    state = {"params": params, "opt": topt.adamw_init(params, oc)}
    state, _ = tloop.make_train_step(model, oc)(state, ref["batch"])
    moe = state["opt"]["mu"]["layers"][1]["moe"]
    assert torch.equal(moe["router_bias"], torch.zeros_like(
        moe["router_bias"]))
    assert float(moe["wg"].abs().sum()) > 0
