"""The port's training path against the JAX package's, on the CPU: the
dense stacks, rwkv6 (the WKV6 recurrence and, under ``rwkv_chunked``,
the chunked form) and zamba2 (the chunked SSD form and the shared
attention block).  ``tests/test_torch_train_models_mixed.py`` holds the
MoE, Qwen2-VL and whisper stacks with the helpers of this file.

For each reduced config, in f32, the reference's ``key(0)`` weights go
to the port through ``params_from_jax``, and so do the reference's
gradients (they share the params' tree).  The batch is the reference's
``make_batch``.  Checks, mirroring ``tests/test_models.py``'s
``test_train_step_smoke`` and ``test_mtp_loss_present``:

* the loss and its metrics against ``jax.value_and_grad(train_loss)``
  within 1e-6 relative, and every gradient leaf within rtol 1e-4 and an
  atol of 1e-5 times the leaf's scale ``max(1, max |g|)``.  The scale is
  above 1 only for the tied embedding (up to 7.5: the head's gradient,
  summed over the batch's positions), whose f32 gradient is
  ill-conditioned on the rwkv6 stack: the reference's own f32 gradient
  lies 7.8 times the unscaled atol from its value with every array in
  f64 (the port's f32 gradient 2.4 times);
* one ``make_train_step`` step (the default ``OptConfig``) against the
  reference's jitted step: the metrics within 1e-6 relative (``lr``
  exactly; the gradient norm at the gradients' rtol 1e-4), the
  parameters within atol 1e-5 / rtol 1e-4, the first moment within
  the gradient's tolerance times its 0.1, the second within rtol 2e-4 and an atol of 1e-6 times the squared scale (0.05
  g^2 doubles g's relative error);
* per-layer recompute (``remat``) against none: the loss and every
  gradient leaf within 1e-6 relative.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import make_batch as jax_make_batch
from repro.models import build_model as jax_build
from repro.train import loop as jloop
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.data import make_batch
from repro_torch.models import build_model, params_from_jax
from repro_torch.train import loop as tloop
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt
from repro_torch.utils.tree import tree_leaves, tree_paths

B, S = 2, 12
ARCHS = ("smollm-135m", "smollm-360m", "gemma-2b", "h2o-danube-1.8b",
         "rwkv6-1.6b", "rwkv6-1.6b-chunked", "zamba2-2.7b")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the test runner's parallel
    workers would otherwise oversubscribe the cores, and a training
    test's many small ops slow tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    """The port's and the reference's reduced config of ``arch``
    (``-chunked``: rwkv6 with ``rwkv_chunked``)."""
    base = arch.removesuffix("-chunked")
    t, j = get_config(base + "-reduced"), jax_config(base, reduced=True)
    if arch.endswith("-chunked"):
        t = dataclasses.replace(t, rwkv_chunked=True)
        j = dataclasses.replace(j, rwkv_chunked=True)
    return t, j


_REFS = {}


def reference(arch):
    """The reference's model, weights, batch, loss / metrics / gradients
    (``value_and_grad``) and one jitted ``make_train_step`` step from
    ``init_state(key(0))``."""
    if arch not in _REFS:
        _, jcfg = configs(arch)
        model = jax_build(jcfg)
        params = model.init(jax.random.key(0))
        batch = jax_make_batch(jcfg, B, S + jcfg.num_patch_tokens, 0)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jlosses.train_loss(model, p, batch, jcfg),
            has_aux=True))(params)
        oc = jopt.OptConfig()
        state = jloop.init_state(model, jax.random.key(0), oc).as_dict()
        new_state, step_metrics = jax.jit(jloop.make_train_step(model, oc))(
            state, batch)
        np_tree = lambda t: jax.tree.map(np.asarray, t)
        _REFS[arch] = dict(
            model=model, params=np_tree(params), batch=batch,
            loss=float(loss), metrics=np_tree(metrics), grads=np_tree(grads),
            state=np_tree(state), new_state=np_tree(new_state),
            step_metrics=np_tree(step_metrics))
    return _REFS[arch]


def port(arch, remat=False):
    """The port's model of ``arch`` on the CPU with the reference's
    weights (a fresh copy)."""
    cfg, _ = configs(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    return (build_model(cfg, device="cpu"),
            params_from_jax(reference(arch)["params"], cfg, "cpu"))


def as_port(tree, arch):
    """A tree of the reference's params layout (its gradients, moments)
    in the port's layout."""
    return params_from_jax(tree, configs(arch)[0], "cpu")


def port_loss_and_grads(model, params, batch):
    """The port's loss, metrics and the gradient of every leaf (a zero
    gradient for a leaf the loss does not reach)."""
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics = tlosses.train_loss(model, params, tb, model.cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, [
        torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def assert_leaves_close(paths, out, ref, rtol, atol, scale_pow=1):
    """Every leaf within ``rtol`` and ``atol`` times the leaf's scale
    max(1, max |ref|) to the power ``scale_pow``."""
    for path, o, r in zip(paths, out, ref):
        o, r = o.detach().float().numpy(), r.detach().float().numpy()
        scale = max(1.0, float(np.abs(r).max()) if r.size else 1.0)
        np.testing.assert_allclose(o, r, rtol=rtol,
                                   atol=atol * scale ** scale_pow,
                                   err_msg=path)


def check_loss_and_grads(arch):
    ref = reference(arch)
    model, params = port(arch)
    loss, metrics, grads = port_loss_and_grads(model, params, ref["batch"])
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert set(metrics) == set(ref["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(ref["metrics"][k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    gref = as_port(ref["grads"], arch)
    assert tree_paths(gref) == tree_paths(params)
    assert_leaves_close(tree_paths(params), grads, tree_leaves(gref),
                        rtol=1e-4, atol=1e-5)


def check_train_step(arch):
    """One step of the port's ``make_train_step`` from the reference's
    initial state against the reference's step."""
    ref = reference(arch)
    model, params = port(arch)
    st = ref["state"]
    state = {"params": params,
             "opt": {"mu": as_port(st["opt"]["mu"], arch),
                     "nu": as_port(st["opt"]["nu"], arch),
                     "step": torch.tensor(int(st["opt"]["step"]),
                                      dtype=torch.int32)}}
    new, metrics = tloop.make_train_step(model, topt.OptConfig())(
        state, ref["batch"])
    jm = ref["step_metrics"]
    assert set(metrics) == set(jm)
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        # the global norm is a function of the gradients: their rtol
        np.testing.assert_allclose(float(v), float(jm[k]),
                                   rtol=1e-4 if k == "grad_norm" else 1e-6,
                                   atol=1e-7, err_msg=k)
    assert float(metrics["lr"]) == float(jm["lr"])
    assert int(new["opt"]["step"]) == 1
    jn = ref["new_state"]
    paths = tree_paths(params)
    assert_leaves_close(paths, tree_leaves(new["params"]),
                        tree_leaves(as_port(jn["params"], arch)), 1e-4, 1e-5)
    assert_leaves_close(paths, tree_leaves(new["opt"]["mu"]),
                        tree_leaves(as_port(jn["opt"]["mu"], arch)),
                        1e-4, 1e-6)
    assert_leaves_close(paths, tree_leaves(new["opt"]["nu"]),
                        tree_leaves(as_port(jn["opt"]["nu"], arch)),
                        2e-4, 1e-6, scale_pow=2)
    # the smoke checks of the reference's test_train_step_smoke
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    assert not any(bool(torch.isnan(p).any())
                   for p in tree_leaves(new["params"]))


def check_remat(arch):
    ref = reference(arch)
    out = {}
    for remat in (False, True):
        model, params = port(arch, remat=remat)
        assert model.cfg.remat is remat
        out[remat] = port_loss_and_grads(model, params, ref["batch"])
    (l0, m0, g0), (l1, m1, g1) = out[False], out[True]
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(arch):
    check_remat(arch)


def test_remat_recomputes_each_layer(monkeypatch):
    """Under ``remat`` and grad, the backward runs each layer's forward
    again (the shared block with it); without grad, or with remat off,
    each layer runs once."""
    from repro_torch.models import transformer as ttfm

    calls = []
    block_fwd = ttfm.block_fwd
    monkeypatch.setattr(ttfm, "block_fwd",
                        lambda *a, **k: calls.append(1) or block_fwd(*a, **k))
    batch = reference("zamba2-2.7b")["batch"]
    for remat, grad, runs in ((True, True, 2), (True, False, 1),
                              (False, True, 1)):
        calls.clear()
        model, params = port("zamba2-2.7b", remat=remat)
        with torch.set_grad_enabled(grad):
            if grad:
                port_loss_and_grads(model, params, batch)
            else:
                model.forward(params, {"tokens": torch.as_tensor(
                    batch["tokens"])})
        assert len(calls) == runs * model.cfg.num_layers, (remat, grad)


def test_make_batch_feeds_the_port_model():
    """The port's own ``make_batch`` is the reference's, so the port's
    step runs on it as the reference's does."""
    cfg, jcfg = configs("smollm-135m")
    for k, v in make_batch(cfg, B, S, 0).items():
        np.testing.assert_array_equal(v, jax_make_batch(jcfg, B, S, 0)[k])


def test_unused_leaf_gets_a_zero_gradient():
    """A leaf the loss does not reach gets a zero gradient and its
    moments stay zero, as under ``jax.grad``."""
    model, params = port("smollm-135m")
    params["unused"] = torch.ones(3)
    oc = topt.OptConfig()
    state = {"params": params, "opt": topt.adamw_init(params, oc)}
    state, _ = tloop.make_train_step(model, oc)(
        state, reference("smollm-135m")["batch"])
    assert torch.equal(state["opt"]["mu"]["unused"], torch.zeros(3))
    assert torch.equal(state["opt"]["nu"]["unused"], torch.zeros(3))
