"""The port's attention kernels against the JAX package's Pallas kernels.

Inputs are drawn with numpy from a seed and handed to both packages.
On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernels run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against the same plain versions
there); the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Tolerances are the repo's: f32 2e-5,
bf16 2e-2 (absolute and relative).
"""
import contextlib
import ctypes
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.swa_prefill.ops import swa_prefill_attention as jax_prefill
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.swa_prefill import ops as pre
from repro_torch.utils import counters

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def both(a, name="float32"):
    """One numpy array as a JAX array and a CPU tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# swa_prefill: plain version vs the Pallas kernel
# --------------------------------------------------------------------------
PREFILL_SWEEP = [                 # tests/test_kernels.py::test_swa_prefill_sweep
    (2, 256, 4, 2, 32, 64, 64),
    (1, 512, 2, 2, 64, 128, 128),
    (2, 128, 3, 1, 16, 1000, 64),     # window >= seq: full causal
    (1, 256, 2, 2, 32, 32, 64),       # window < block
]
PREFILL_RAGGED = [                # ..._ragged_and_window_edges
    (1, 77, 2, 2, 32, 32, 256),       # odd s, single odd block
    (1, 77, 2, 1, 32, 1000, 256),     # odd s, window >= s (full causal)
    (2, 96, 3, 3, 16, 40, 32),        # non-pow2 s, multi-block, ragged w
    (1, 160, 4, 2, 32, 33, 32),       # window straddles blocks
    (1, 64, 2, 2, 32, 1, 32),         # window=1: pure self-attention
    (2, 33, 1, 1, 16, 17, 64),        # prime-ish s, single head
    (1, 256, 9, 3, 64, 256, 256),     # smollm-135m serving shape, G = 3
    (1, 64, 4, 4, 80, 4096, 64),      # zamba2's shared block: D = 80
    (2, 40, 2, 2, 80, 16, 40),        # D = 80, the reduced cut's window 16
    (1, 64, 8, 1, 256, 4096, 64),     # gemma-2b: D = 256, 8 heads over 1
    (2, 40, 4, 1, 256, 16, 40),       # D = 256 under a window of 16
    (1, 96, 4, 2, 80, 32, 32),        # h2o-danube's widths, window < S
]


def _prefill_case(b, s, h, kv, d, w, blk, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d))
    k = rng.standard_normal((b, s, kv, d))
    v = rng.standard_normal((b, s, kv, d))
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    ref = jax_prefill(jq, jk, jv, window=w, block=blk)
    before = counters.read()["swa_prefill"]
    out = pre.swa_prefill_attention(tq, tk, tv, window=w)
    # the CPU never counts a launch
    assert counters.read()["swa_prefill"] == before
    assert out.shape == (b, s, h, d) and out.dtype == tq.dtype
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


@pytest.mark.parametrize("b,s,h,kv,d,w,blk", PREFILL_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_prefill_plain_matches_pallas(b, s, h, kv, d, w, blk, dtype):
    _prefill_case(b, s, h, kv, d, w, blk, dtype, seed=s + h + w)


@pytest.mark.parametrize("b,s,h,kv,d,w,blk", PREFILL_RAGGED)
def test_swa_prefill_plain_ragged_and_window_edges(b, s, h, kv, d, w, blk):
    _prefill_case(b, s, h, kv, d, w, blk, "float32", seed=s * 7 + w)


def test_swa_prefill_plain_window_one_is_v():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 40, 2, 16)))
               .float() for _ in range(3))
    out = pre.swa_prefill_plain(q, k, v, window=1)
    np.testing.assert_allclose(out.numpy(), v.numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# decode_attention: plain version vs the Pallas kernel
# --------------------------------------------------------------------------
DECODE_SWEEP = [                  # tests/test_kernels.py sweeps + ragged
    (1, 1, 1, 64, 128, 64, None),
    (2, 3, 4, 64, 256, 64, None),
    (2, 2, 2, 128, 512, 256, None),
    (4, 1, 8, 64, 128, 128, None),        # MQA-style
    (1, 1, 1, 32, 77, 512, [1]),          # odd s, minimal cache
    (1, 2, 4, 32, 77, 512, [77]),         # odd s, full-length cache
    (2, 2, 2, 32, 96, 32, [31, 33]),      # lens straddle block edges
    (3, 1, 2, 16, 96, 32, [32, 64, 96]),  # lens on block edges
    (1, 3, 1, 64, 60, 20, [59]),          # non-pow2 everything, g=1
    (4, 3, 3, 64, 321, 321, [0, 1, 160, 321]),  # serving shape, length 0
    (2, 4, 1, 80, 48, 48, [1, 48]),       # zamba2's shared block: D = 80
    (2, 2, 1, 80, 16, 16, [9, 16]),       # D = 80 on a full 16-slot ring
    (4, 1, 8, 256, 64, 64, [0, 1, 33, 64]),  # gemma-2b: D = 256, G = 8
    (2, 2, 4, 80, 32, 32, [17, 32]),      # h2o-danube's widths, a full ring
]


@pytest.mark.parametrize("b,kv,g,d,s,block_s,lens", DECODE_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(b, kv, g, d, s, block_s, lens,
                                               dtype):
    rng = np.random.default_rng(b * 1000 + s + g)
    q = rng.standard_normal((b, kv, g, d))
    k = rng.standard_normal((b, s, kv, d))
    v = rng.standard_normal((b, s, kv, d))
    lens = np.asarray(rng.integers(1, s + 1, (b,)) if lens is None else lens,
                      np.int32)
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    ref = jax_decode(jq, jk, jv, jnp.asarray(lens), block_s=block_s)
    before = counters.read()["decode_attention"]
    out = dec.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert counters.read()["decode_attention"] == before
    assert out.shape == (b, kv, g, d) and out.dtype == tq.dtype
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


def test_decode_attention_plain_length_zero_is_mean_of_v():
    """The finite -1e30 mask: a length of 0 averages all S rows of V."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 2, 3, 16))).float()
    k = torch.from_numpy(rng.standard_normal((1, 10, 2, 16))).float()
    v = torch.from_numpy(rng.standard_normal((1, 10, 2, 16))).float()
    out = dec.decode_attention_plain(q, k, v, torch.zeros(1, dtype=torch.int32))
    mean = v.mean(dim=1)[:, :, None, :].expand(1, 2, 3, 16)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), mean.numpy(), atol=1e-6)


def test_decode_attention_plain_ignores_rows_past_length():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 2, 32))).float()
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 32))).float()
    v = torch.from_numpy(rng.standard_normal((2, 64, 2, 32))).float()
    lens = torch.tensor([40, 50], dtype=torch.int32)
    out1 = dec.decode_attention_plain(q, k, v, lens)
    k[:, 50:], v[:, 50:] = 999.0, -999.0
    out2 = dec.decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(out1.numpy(), out2.numpy())


# --------------------------------------------------------------------------
# decode_attention's log-sum-exp: calls over row ranges merged
# --------------------------------------------------------------------------
def split_calls(q, k, v, lens, n_parts):
    """``decode_attention(..., return_lse=True)`` over ``n_parts`` equal
    row ranges of the cache, each with its local lengths
    ``clamp(len - start, 0, n_local)`` (a sequence-sharded cache's
    ranks)."""
    n_local = k.shape[1] // n_parts
    parts = []
    for r in range(n_parts):
        rows = slice(r * n_local, (r + 1) * n_local)
        local = torch.clamp(lens - r * n_local, 0, n_local).to(torch.int32)
        parts.append(dec.decode_attention(q, k[:, rows].contiguous(),
                                          v[:, rows].contiguous(), local,
                                          return_lse=True))
    return parts


LSE_SHAPES = [                    # (b, kv, g, d, s, lens)
    (4, 3, 3, 64, 320, [1, 2, 161, 320]),     # smollm's widths
    (2, 8, 4, 80, 16, [16, 7]),               # h2o-danube's, a 16-slot ring
    (1, 1, 8, 256, 64, [31]),                 # gemma-2b's D 256, G 8
]


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("b,kv,g,d,s,lens", LSE_SHAPES)
def test_decode_attention_lse_merged_over_row_splits_equals_whole_call(
        b, kv, g, d, s, lens, n_parts):
    """Every length is at least 1 (row 0 is always valid in a decode),
    so the ranges past a length, whose local length is 0, weigh exactly
    0 in the merge."""
    rng = np.random.default_rng(s + n_parts)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)).float()
               for shape in ((b, kv, g, d), (b, s, kv, d), (b, s, kv, d)))
    lens = torch.tensor(lens, dtype=torch.int32)
    whole, lse = dec.decode_attention(q, k, v, lens, return_lse=True)
    assert lse.shape == (b, kv, g) and lse.dtype == torch.float32
    np.testing.assert_array_equal(whole.numpy(),
                                  dec.decode_attention(q, k, v, lens).numpy())
    parts = split_calls(q, k, v, lens, n_parts)
    assert any(float(part_lse.min()) <= -1e29 for _, part_lse in parts)
    merged = dec.merge_by_lse(parts)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **tol("float32"))
    np.testing.assert_allclose(
        torch.logsumexp(torch.stack([x for _, x in parts]), 0).numpy(),
        lse.numpy(), **tol("float32"))


def test_decode_attention_plain_lse_is_the_scores_log_sum_exp():
    """Over the valid rows, in float64; a length of 0 gives -1e30 + log S
    (the finite mask), which is -1e30 in f32."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 2, 3, 32))
    k = rng.standard_normal((2, 24, 2, 32))
    v = rng.standard_normal((2, 24, 2, 32))
    lens = np.array([0, 17], np.int32)
    _, lse = dec.decode_attention_plain(
        *(torch.from_numpy(a).float() for a in (q, k, v)),
        torch.from_numpy(lens), return_lse=True)
    scores = np.einsum("bkgd,bskd->bkgs", q, k) / np.sqrt(32)
    want = np.log(np.exp(scores[1, :, :, :17]).sum(-1))
    np.testing.assert_allclose(lse[1].numpy(), want, atol=2e-5, rtol=2e-5)
    assert (lse[0] == -1e30).all()


@pytest.mark.parametrize("s_cache", [1, 6, 16])
def test_ring_decode_mask_is_the_prefix_of_min_index_plus_one(s_cache):
    """The reference's ring-buffer mask ``(slot - j) % S <= index`` of
    ``attention._decode_plain`` keeps exactly the slots ``j < min(index
    + 1, S)`` at every index across the wraps, so the ring decode equals
    the kernel's plain version at that length, and so does its merge
    over row ranges (what each rank of a sequence-sharded cache
    computes)."""
    from repro_torch.models.attention import _decode_plain

    rng = np.random.default_rng(s_cache)
    q = torch.from_numpy(rng.standard_normal((2, 2, 2, 16))).float()
    k = torch.from_numpy(rng.standard_normal((2, s_cache, 2, 16))).float()
    v = torch.from_numpy(rng.standard_normal((2, s_cache, 2, 16))).float()
    j = torch.arange(s_cache)
    for index in range(3 * s_cache + 2):
        index_t = torch.tensor(index)
        slot = index_t % s_cache
        assert torch.equal((slot - j) % s_cache <= index_t,
                           j < min(index + 1, s_cache))
        ring = _decode_plain(q, k, v, index_t, slot, s_cache, 0.0)
        lens = torch.full((2,), min(index + 1, s_cache), dtype=torch.int32)
        np.testing.assert_allclose(
            ring.numpy(), dec.decode_attention_plain(q, k, v, lens).numpy(),
            **tol("float32"))
        if s_cache % 2 == 0:
            np.testing.assert_allclose(
                dec.merge_by_lse(split_calls(q, k, v, lens, 2)).numpy(),
                ring.numpy(), **tol("float32"))


# --------------------------------------------------------------------------
# wrappers: the plain version only for CPU tensors
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["swa_prefill", "decode_attention"])
def test_wrapper_refuses_a_device_without_a_kernel(kernel):
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel (CUDA) or raises, never falls back."""
    if kernel == "swa_prefill":
        q = torch.empty(1, 8, 2, 16, device="meta")
        kv = torch.empty(1, 8, 1, 16, device="meta")
        call = lambda: pre.swa_prefill_attention(q, kv, kv, window=8)
    else:
        q = torch.empty(1, 1, 2, 16, device="meta")
        kv = torch.empty(1, 8, 1, 16, device="meta")
        lens = torch.ones(1, dtype=torch.int32, device="meta")
        call = lambda: dec.decode_attention(q, kv, kv, lens)
    with pytest.raises(ValueError, match="no kernel for device"):
        call()


@pytest.mark.parametrize("case", ["dtype", "head_dim", "window", "shape"])
def test_prefill_check_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    window = 8
    if case == "dtype":
        q, k = q.half(), k.half()
    elif case == "head_dim":
        q, k = torch.zeros(1, 8, 4, 48), torch.zeros(1, 8, 2, 48)
    elif case == "window":
        window = 0
    else:
        k = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError):
        pre._check(q, k, k, window)


@pytest.mark.parametrize("case", ["lengths_dtype", "group", "shape"])
def test_decode_check_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(2, 3, 3, 64)
    k = torch.zeros(2, 16, 3, 64)
    lens = torch.ones(2, dtype=torch.int32)
    if case == "lengths_dtype":
        lens = lens.long()
    elif case == "group":
        q = torch.zeros(2, 3, 9, 64)
    else:
        k = torch.zeros(2, 16, 2, 64)
    with pytest.raises(ValueError):
        dec._check(q, k, k, lens)


def test_checks_take_head_dim_256_and_refuse_others():
    """Both wrappers take gemma-2b's head_dim 256 (a CUDA tensor of that
    width launches the kernel) and refuse a width the kernels do not
    instantiate."""
    pre._check(torch.zeros(1, 8, 8, 256), torch.zeros(1, 8, 1, 256),
               torch.zeros(1, 8, 1, 256), 8)
    dec._check(torch.zeros(2, 1, 8, 256), torch.zeros(2, 16, 1, 256),
               torch.zeros(2, 16, 1, 256), torch.ones(2, dtype=torch.int32))
    for d in (96, 192, 512):
        with pytest.raises(ValueError, match="head dim"):
            pre._check(torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 1, d),
                       torch.zeros(1, 8, 1, d), 8)
        with pytest.raises(ValueError, match="head dim"):
            dec._check(torch.zeros(2, 1, 2, d), torch.zeros(2, 16, 1, d),
                       torch.zeros(2, 16, 1, d),
                       torch.ones(2, dtype=torch.int32))


def test_build_targets_name_each_source_by_content():
    """The sources are every ``csrc/*.cu``; each builds into its own
    library, named by a hash of its source, the shared header and the
    flags, under the ignored build directory; nothing is built at
    import."""
    assert build.SOURCES == ("add_rms_norm", "decode_attention",
                             "decode_gemm", "glu_gate",
                             "mamba2_conv_step", "mamba2_gate_norm",
                             "rope_kv_write", "rwkv6_scan", "ssd_scan",
                             "swa_prefill")
    targets = {n: build._target(n) for n in build.SOURCES}
    assert len({t.name for t in targets.values()}) == len(build.SOURCES)
    for name, t in targets.items():
        assert t.parent == build.BUILD_DIR
        assert t.name.startswith(f"lib{name}-") and t.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").is_file()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build._loaded == {} or all(n in build.SOURCES for n in build._loaded)


@pytest.mark.parametrize("header", ["common.cuh", "mma.cuh", "new.cuh"])
def test_build_targets_change_with_every_shared_header(header, tmp_path,
                                                       monkeypatch):
    """Every library's name hashes every ``*.cuh`` under ``csrc``, so a
    changed (or new) shared header rebuilds every kernel instead of
    loading a stale library; the same sources elsewhere give the same
    names."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {n: build._target(n) for n in build.SOURCES}
    monkeypatch.setattr(build, "CSRC", csrc)
    assert {n: build._target(n) for n in build.SOURCES} == before
    path = csrc / header
    old = path.read_bytes() if path.exists() else b""
    path.write_bytes(old + b"\n// changed\n")
    after = {n: build._target(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    assert len({t.name for t in after.values()}) == len(build.SOURCES)


@pytest.mark.parametrize("err", [0, 7])
def test_launcher_counts_a_launch_or_raises(err, monkeypatch):
    """``build.kernel``'s launcher loads ``repro_<name>`` at its first
    call, sets its C types, and calls it with the arguments and the
    device's current stream, read again at every call; a return of 0
    counts one launch under the kernel's name, a CUDA error raises with
    the name and counts nothing."""
    calls, loads, devices = [], [], []

    class Entry:
        def __call__(self, *args):
            calls.append(args)
            return err

    lib = types.SimpleNamespace(repro_glu_gate=Entry())
    stream = types.SimpleNamespace(cuda_stream=99)
    monkeypatch.setattr(build, "load", lambda name: loads.append(name) or lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: (
        devices.append(device) or contextlib.nullcontext()))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setitem(counters.COUNTS, "glu_gate",
                        counters.read()["glu_gate"])
    launch = build.kernel("glu_gate", [ctypes.c_void_p, ctypes.c_int])
    assert loads == []                  # nothing loaded before a launch
    before = counters.read()
    if err:
        with pytest.raises(RuntimeError, match="glu_gate kernel launch "
                                               "failed: CUDA error 7"):
            launch("cuda:1", 1, 2)
        assert counters.read() == before
    else:
        launch("cuda:1", 1, 2)
        stream.cuda_stream = 100        # a capture's own stream
        launch("cuda:1", 3, 4)
        assert counters.delta(counters.read(), before) == {"glu_gate": 2}
        assert calls[1:] == [(3, 4, 100)]
    assert loads == ["glu_gate"] and devices[0] == "cuda:1"
    assert calls[0] == (1, 2, 99)
    assert lib.repro_glu_gate.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p]
    assert lib.repro_glu_gate.restype is ctypes.c_int
