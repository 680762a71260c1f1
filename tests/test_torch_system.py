"""The port's training substrate against the JAX package's, on the CPU,
mirroring ``tests/test_system.py``: checkpoints (the reference's file
format, read both ways), the synthetic data stream (byte for byte the
reference's), the tree helpers' paths, ``INPUT_SHAPES``, the training
loop's falling loss at the reference's own settings, and the training
launcher.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_config
from repro.data import make_batch as jax_make_batch
from repro.data import synthetic_batches as jax_batches
from repro.models import build_model as jax_build
from repro.utils import tree as jtree
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.data import make_batch, synthetic_batches
from repro_torch.launch import train as launcher
from repro_torch.models import build_model
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.utils import tree as ttree

ARCH = "smollm-135m-reduced"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the test runner's parallel
    workers would otherwise oversubscribe the cores, and a training
    test's many small ops slow tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    """The reduced model's params, with one leaf in bf16, saved and
    restored into a fresh exemplar: every leaf equal, dtype kept; the
    metadata and ``latest_checkpoint``."""
    m = build_model(get_config(ARCH), device="cpu")
    params = m.init(m.generator(0))
    params["layers"][0]["norm1"] = torch.randn(
        params["layers"][0]["norm1"].shape).bfloat16()
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    tckpt.save_checkpoint(str(tmp_path), params, step=3)
    f = tckpt.save_checkpoint(str(tmp_path), params, step=7,
                              metadata={"x": 1})
    assert tckpt.latest_checkpoint(str(tmp_path)) == f
    assert f.endswith("ckpt_00000007.npz")
    exemplar = m.init(m.generator(1))
    exemplar["layers"][0]["norm1"] = exemplar["layers"][0]["norm1"].bfloat16()
    restored, meta = tckpt.restore_checkpoint(f, exemplar)
    assert meta["step"] == 7 and meta["x"] == 1
    assert meta["bf16_keys"] == ["layers::0::norm1"]
    for a, b in zip(ttree.tree_leaves(params), ttree.tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_checks_shapes(tmp_path):
    f = tckpt.save_checkpoint(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(f, {"a": torch.zeros(4)})


def flat_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "h": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
            "blocks": [{"k": rng.integers(0, 9, (2,)).astype(np.int32)}]}


def as_torch(t):
    return jax.tree.map(lambda a: torch.from_numpy(
        a.astype(np.float32)).bfloat16() if a.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(a), t)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_files_cross_read(writer, tmp_path):
    """A file written by either package is read by the other's reader
    (a tree of the same layout, a bf16 leaf among f32 and int32)."""
    tree = flat_tree(0)
    if writer == "reference":
        f = jckpt.save_checkpoint(str(tmp_path),
                                  jax.tree.map(jnp.asarray, tree), step=5,
                                  metadata={"arch": "x"})
        out, meta = tckpt.restore_checkpoint(
            f, jax.tree.map(torch.zeros_like, as_torch(tree)))
        assert out["h"].dtype == torch.bfloat16
        got = jax.tree.map(lambda t: t.float().numpy(), out)
    else:
        f = tckpt.save_checkpoint(str(tmp_path), as_torch(tree), step=5,
                                  metadata={"arch": "x"})
        out, meta = jckpt.restore_checkpoint(
            f, jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            tree))
        assert out["h"].dtype == jnp.bfloat16
        got = jax.tree.map(lambda a: np.asarray(a, np.float32), out)
    assert meta["step"] == 5 and meta["arch"] == "x"
    assert meta["bf16_keys"] == ["h"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    # the same keys and stored arrays as the reference writes them
    with np.load(f) as data:
        assert sorted(data.files) == ["blocks::0::k", "h", "w"]
        assert data["h"].dtype == np.uint16
        np.testing.assert_array_equal(data["h"], tree["h"].view(np.uint16))
    with open(f + ".json") as fh:
        assert json.load(fh)["bf16_keys"] == ["h"]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-vl-2b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("with_labels", [True, False])
def test_make_batch_is_the_reference_byte_for_byte(arch, with_labels):
    """Tokens, labels, Qwen2-VL's patch prefix and M-RoPE grid, and
    whisper's encoder frames, at the reduced and the full config."""
    for reduced in (True, False):
        cfg = get_config(arch + ("-reduced" if reduced else ""))
        jcfg = jax_config(arch, reduced=reduced)
        seq = 24 + cfg.num_patch_tokens
        out = make_batch(cfg, 3, seq, 11, with_labels=with_labels)
        ref = jax_make_batch(jcfg, 3, seq, 11, with_labels=with_labels)
        assert sorted(out) == sorted(ref)
        for k in ref:
            assert (out[k].dtype, out[k].shape) == (ref[k].dtype,
                                                    ref[k].shape)
            assert out[k].tobytes() == ref[k].tobytes(), (arch, k)


def test_data_pipeline_deterministic():
    cfg = get_config(ARCH)
    b1 = make_batch(cfg, 4, 32, 123)
    b2 = make_batch(cfg, 4, 32, 123)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 32)
    assert b1["labels"][0, -1] == -100
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_synthetic_batches_match_reference():
    cfg, jcfg = get_config(ARCH), jax_config("smollm-135m", reduced=True)
    for a, b in zip(synthetic_batches(cfg, 2, 16, 4, seed=3),
                    jax_batches(jcfg, 2, 16, 4, seed=3)):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()


# --------------------------------------------------------------------------
# tree helpers and shapes
# --------------------------------------------------------------------------

def test_tree_paths_are_the_reference_paths():
    """The port's params of a grouped stack in the reference's path
    strings (its stacked groups become per-layer lists, so the layout is
    the port's own), and a mixed tree of dicts, lists and tuples."""
    tree = {"b": [np.zeros(2), (np.zeros(3), {"z": np.zeros(1),
                                              "a": np.zeros((2, 2))})],
            "a": np.zeros(4), "n": None}
    assert ttree.tree_paths(tree) == jtree.tree_paths(tree)
    assert ttree.tree_size(tree) == jtree.tree_size(tree)
    assert ttree.tree_bytes(tree) == jtree.tree_bytes(tree)
    seen = []
    ttree.tree_map_with_path(lambda p, x: seen.append(p), tree)
    jseen = []
    jtree.tree_map_with_path(lambda p, x: jseen.append(p), tree)
    assert seen == jseen
    out = ttree.tree_map_with_path(lambda p, x: x.shape, tree)
    assert out["b"][1][1]["a"] == (2, 2) and out["n"] is None
    # the whole reference param tree and its numpy leaves
    jparams = jax_build(jax_config("kimi-k2-1t-a32b", reduced=True)).init(
        jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    assert ttree.tree_paths(np_tree) == jtree.tree_paths(jparams)
    assert ttree.tree_size(np_tree) == jtree.tree_size(jparams)
    assert ttree.tree_bytes(np_tree) == jtree.tree_bytes(jparams)


def test_tree_sizes_count_tensors():
    t = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
         "b": [torch.zeros(5)]}
    assert ttree.tree_size(t) == 17
    assert ttree.tree_bytes(t) == 3 * 4 * 2 + 5 * 4


def test_input_shapes_are_the_reference():
    assert INPUT_SHAPES.keys() == JAX_SHAPES.keys()
    for k, v in JAX_SHAPES.items():
        assert (INPUT_SHAPES[k].name, INPUT_SHAPES[k].seq_len,
                INPUT_SHAPES[k].global_batch, INPUT_SHAPES[k].kind) == (
            v.name, v.seq_len, v.global_batch, v.kind)


# --------------------------------------------------------------------------
# the loop and the launcher
# --------------------------------------------------------------------------

def test_training_loss_decreases():
    """The reference's own settings (``test_system.py``): lr 1e-3,
    warmup 3, 25 steps of batch 4 x seq 32, logged every 8 steps."""
    torch.manual_seed(0)
    cfg = get_config(ARCH)
    m = build_model(cfg, device="cpu")
    oc = OptConfig(lr=1e-3, warmup_steps=3, total_steps=25)
    state, hist = train_loop(m, synthetic_batches(cfg, 4, 32, 25), oc,
                             log_every=8)
    assert [h["step"] for h in hist] == [0, 8, 16, 24]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3
    assert set(hist[0]) == {"loss", "ce", "aux", "grad_norm", "lr", "step",
                            "wall_s"}
    assert int(state["opt"]["step"]) == 25


def test_launcher_trains_and_checkpoints_on_cpu(tmp_path, capsys):
    launcher.main(["--arch", ARCH, "--steps", "6", "--batch", "2",
                   "--seq", "16", "--log-every", "2", "--device", "cpu",
                   "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("step ") == 6        # the callback logs every step
    assert "checkpoint:" in out and "loss " in out
    f = tckpt.latest_checkpoint(str(tmp_path))
    assert f.endswith("ckpt_00000006.npz")
    with open(f + ".json") as fh:
        assert json.load(fh)["arch"] == ARCH
    m = build_model(get_config(ARCH), device="cpu")
    restored, _ = tckpt.restore_checkpoint(f, m.init(m.generator(5)))
    assert all(torch.isfinite(x).all() for x in ttree.tree_leaves(restored))


def test_launcher_dtype_flag(capsys):
    launcher.main(["--arch", ARCH, "--steps", "2", "--batch", "1",
                   "--seq", "8", "--device", "cpu", "--dtype", "bfloat16"])
    assert "loss " in capsys.readouterr().out


def test_launcher_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", ARCH, "--steps", "1"])
