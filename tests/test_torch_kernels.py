"""The port's attention kernels against the JAX package's Pallas kernels.

Inputs are drawn with numpy from a seed and handed to both packages.
On the CPU the port's wrappers take their plain PyTorch versions (the
CUDA kernels run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against the same plain versions
there); the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Tolerances are the repo's: f32 2e-5,
bf16 2e-2 (absolute and relative).
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.swa_prefill.ops import swa_prefill_attention as jax_prefill
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.swa_prefill import ops as pre

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
    before = pre.launches
    out = pre.swa_prefill_attention(tq, tk, tv, window=w)
    assert pre.launches == before          # the CPU never counts a launch
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
    before = dec.launches
    out = dec.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert dec.launches == before
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
    """Each kernel source builds into its own library, named by a hash
    of its source, the shared header and the flags, under the ignored
    build directory; nothing is built at import."""
    targets = {n: build._target(n) for n in build.SOURCES}
    assert set(targets) == {"swa_prefill", "decode_attention", "rwkv6_scan",
                            "ssd_scan"}
    assert len({t.name for t in targets.values()}) == 4
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
