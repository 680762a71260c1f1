"""The port's loss and AdamW against the JAX package's, on the CPU.

The same inputs, drawn with numpy from a seed, go through the
reference's ``repro.train.losses`` / ``repro.train.optimizer`` and the
port's ``repro_torch.train``.  Tolerances: the cross-entropy within
1e-6 relative (an f32 log-sum-exp over a few hundred columns).  The
schedule is equal in f32 given the same f32 cosine; the reference's on
the CPU is glibc's ``cosf`` (XLA calls it), PyTorch's another
implementation within one ulp of it, which the schedule scales by its
lr * (1 - min_lr_frac).  AdamW within rtol 1e-6, with an atol of 1e-6
of each leaf's largest magnitude: the clip scale comes from a global
norm summed in another order, one ulp apart, and where 0.9 mu and 0.1 g
cancel that ulp is all that is left.  The global norm within 1e-6
relative.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro_torch.train import losses as tlosses
from repro_torch.train import optimizer as topt


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the test runner's parallel
    workers would otherwise oversubscribe the cores, and a training
    test's many small ops slow tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def test_ignore_is_the_reference_value():
    assert tlosses.IGNORE == jlosses.IGNORE == -100


@pytest.mark.parametrize("vocab,vpad", [(100, 100), (100, 128), (250, 256)])
def test_softmax_xent_matches_reference(vocab, vpad):
    """IGNORE labels, labels at or above vocab_size (masked) and a padded
    vocabulary (the pad columns stay in the normaliser)."""
    rng = np.random.default_rng(vpad + vocab)
    logits = (rng.standard_normal((3, 11, vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, vpad, (3, 11)).astype(np.int32)
    labels[0, :3] = jlosses.IGNORE
    labels[1, 4] = vocab                  # the first pad id: masked
    labels[2, -1] = vpad - 1
    ref = jlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), vocab)
    out = tlosses.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(labels), vocab)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=1e-6)


def test_softmax_xent_all_ignored_is_zero():
    logits = torch.zeros(2, 3, 8)
    labels = torch.full((2, 3), tlosses.IGNORE, dtype=torch.int32)
    assert float(tlosses.softmax_xent(logits, labels, 8)) == 0.0


def test_softmax_xent_bf16_logits_in_f32():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 64)).astype(ml_dtypes.bfloat16)
    labels = rng.integers(0, 64, (2, 5)).astype(np.int32)
    ref = jlosses.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 60)
    out = tlosses.softmax_xent(
        torch.from_numpy(logits.astype(np.float32)).bfloat16(),
        torch.from_numpy(labels), 60)
    np.testing.assert_allclose(as_np(out), np.asarray(ref), rtol=1e-6)


def test_next_token_labels_match_reference():
    toks = np.random.default_rng(0).integers(0, 50, (3, 9)).astype(np.int32)
    ref = jlosses.next_token_labels(jnp.asarray(toks))
    out = tlosses.next_token_labels(torch.from_numpy(toks))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------
# the schedule and the global norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("oc", [
    dict(), dict(warmup_steps=3, total_steps=25, lr=1e-3),
    dict(warmup_steps=1, total_steps=20), dict(warmup_steps=0, total_steps=7),
    dict(warmup_steps=10, total_steps=10, min_lr_frac=0.0)])
def test_lr_at_equals_reference_in_f32(oc, monkeypatch):
    joc, toc = jopt.OptConfig(**oc), topt.OptConfig(**oc)
    steps = range(toc.total_steps + 6)
    refs = [np.asarray(jopt.lr_at(step, joc)) for step in steps]
    for step, ref in zip(steps, refs):
        out = topt.lr_at(step, toc)
        assert out.dtype == torch.float32 and ref.dtype == np.float32
        # one ulp of the cosine (at most 2**-23 in [-1, 1]) scaled by the
        # schedule's lr * (1 - min_lr_frac), and the products' roundings
        np.testing.assert_allclose(
            out.numpy(), ref, rtol=2 ** -22,
            atol=toc.lr * (1 - toc.min_lr_frac) * 2 ** -23)
        # the same from an int32 step tensor, as adamw_update passes it
        out32 = topt.lr_at(torch.tensor(step, dtype=torch.int32), toc)
        assert out32.numpy() == out.numpy()
    # with the reference's f32 cosine, every other f32 step is its own
    monkeypatch.setattr(torch, "cos", lambda t: torch.from_numpy(
        np.array(jnp.cos(jnp.asarray(t.numpy())))))
    for step, ref in zip(steps, refs):
        out = topt.lr_at(step, toc)
        assert out.numpy() == ref, (step, float(out), float(ref))


def tree_np(seed, with_bf16=False):
    """A small tree with 1-, 2- and 3-D leaves (and a bf16 leaf)."""
    rng = np.random.default_rng(seed)
    t = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32),
         "blk": [{"k": rng.standard_normal((2, 3, 4)).astype(np.float32)},
                 {"k": rng.standard_normal((2, 3, 4)).astype(np.float32)}]}
    if with_bf16:
        t["h"] = rng.standard_normal((4, 4)).astype(ml_dtypes.bfloat16)
    return t


def to_jax(t):
    return jax.tree.map(jnp.asarray, t)


def to_torch(t):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, t)


def test_global_norm_matches_reference():
    t = tree_np(0, with_bf16=True)
    ref = jopt.global_norm(to_jax(t))
    out = topt.global_norm(to_torch(t))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["active", "inactive", "off"])
def test_adamw_update_matches_reference(moments, clip):
    """Three steps from zero moments: the parameters, both moments and
    the metrics within rtol 1e-6; decay only on leaves with ndim >= 2;
    a bf16 parameter leaf cast back to bf16."""
    params = tree_np(1, with_bf16=True)
    # gradients of norm ~17: clip 1.0 scales them, 100.0 does not
    grads = [jax.tree.map(lambda a, s=s: (a * 3).astype(a.dtype),
                          tree_np(10 + s, with_bf16=True)) for s in range(3)]
    kw = dict(active=dict(grad_clip=1.0), inactive=dict(grad_clip=100.0),
              off=dict(grad_clip=0.0))[clip]
    joc = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                         moment_dtype=moments, **kw)
    toc = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                         moment_dtype=moments, **kw)
    jp, tp = to_jax(params), to_torch(params)
    jst, tst = jopt.adamw_init(jp, joc), topt.adamw_init(tp, toc)
    assert tst["mu"]["w"].dtype == (torch.bfloat16 if moments == "bfloat16"
                                    else torch.float32)
    for g in grads:
        jp, jst, jm = jopt.adamw_update(jp, to_jax(g), jst, joc)
        tp, tst, tm = topt.adamw_update(tp, to_torch(g), tst, toc)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(tst["step"]) == int(jst["step"])
        assert tst["step"].dtype == torch.int32
        for a, b in ((jp, tp), (jst["mu"], tst["mu"]), (jst["nu"], tst["nu"])):
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(
                    jax.tree.map(as_np, b))):
                x = np.asarray(x, np.float32)
                np.testing.assert_allclose(y, x, rtol=1e-6,
                                           atol=1e-6 * np.abs(x).max())
    assert tp["h"].dtype == torch.bfloat16
    # the clip is active iff the norm is above grad_clip
    if clip == "active":
        assert float(tm["grad_norm"]) > 1.0


def test_adamw_decays_only_2d_leaves():
    """With zero gradients a leaf moves only by its decay: ndim >= 2
    leaves shrink by lr * wd, 1-D leaves stay put."""
    params = to_torch(tree_np(2))
    before = jax.tree.map(lambda t: t.clone(), params)
    grads = jax.tree.map(torch.zeros_like, params)
    oc = topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                        weight_decay=0.5)
    params, _, m = topt.adamw_update(params, grads,
                                     topt.adamw_init(params, oc), oc)
    lr = float(m["lr"])
    torch.testing.assert_close(params["b"], before["b"], rtol=0, atol=0)
    torch.testing.assert_close(params["w"], before["w"] * (1 - lr * 0.5))
    torch.testing.assert_close(params["blk"][1]["k"],
                               before["blk"][1]["k"] * (1 - lr * 0.5))


def test_adamw_counts_the_reference_layer_axis():
    """A (d,) leaf under ``layers/`` is a decayed (L, d) leaf in the
    reference's stacked layout; outside it (a final norm) it is not."""
    params = {"final_norm": torch.ones(4), "layers": [{"norm1": torch.ones(4)}]}
    grads = jax.tree.map(torch.zeros_like, params)
    oc = topt.OptConfig(lr=1e-1, warmup_steps=0, total_steps=10)
    params, _, m = topt.adamw_update(params, grads,
                                     topt.adamw_init(params, oc), oc)
    assert torch.equal(params["final_norm"], torch.ones(4))
    torch.testing.assert_close(params["layers"][0]["norm1"],
                               torch.ones(4) * (1 - float(m["lr"]) * 0.1))


def test_adamw_updates_in_place():
    params = to_torch(tree_np(3))
    w = params["w"]
    oc = topt.OptConfig(warmup_steps=0)
    st = topt.adamw_init(params, oc)
    mu = st["mu"]["w"]
    out, st2, _ = topt.adamw_update(params, to_torch(tree_np(4)), st, oc)
    assert out["w"] is w and st2["mu"]["w"] is mu
    assert int(st2["step"]) == 1 and float(mu.abs().sum()) > 0
