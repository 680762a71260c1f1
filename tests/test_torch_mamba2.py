"""The port's Mamba2 / zamba2 path against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
The port's ``ssd_scan`` wrapper takes its plain PyTorch version for CPU
tensors (the CUDA kernel runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the same plain version
there); the JAX side runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does, its pure-jnp oracle ``ssd_scan_ref``,
or the reference model's chunked ``ssd_chunked``.  Tolerances: f32
2e-4 and bf16 5e-2 (absolute and relative) for the scan, as the repo's
SSD tests; atol 1e-4 for the mixer and the model, as
``tests/test_torch_models.py``; 1e-5 where the port is held against
itself (state continuation).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.ssd_scan.ops import ssd_scan as jax_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models import build_model as jax_build
from repro.models import mamba2 as jm2
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import mamba2 as tm2

ATOL = 1e-4
ARCH = "zamba2-2.7b-reduced"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)


def both(a, name="float32"):
    """One numpy array as a JAX array and a CPU tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def scan_inputs(b, t, h, p, n, seed):
    """x, dt, a_log, B, C, h0 as numpy arrays, drawn as
    tests/test_kernels.py draws them (dt after a softplus)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p))
    dt = np.logaddexp(rng.standard_normal((b, t, h)), 0.0)
    a_log = rng.standard_normal(h) * 0.3
    bm = rng.standard_normal((b, t, n))
    cm = rng.standard_normal((b, t, n))
    h0 = rng.standard_normal((b, h, p, n)) * 0.1
    return x, dt, a_log, bm, cm, h0


def routes(cfg, on: bool):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


# --------------------------------------------------------------------------
# the SSD scan: plain version vs the Pallas kernel and its oracle
# --------------------------------------------------------------------------
SWEEP = [(1, 16, 1, 16, 8, 8),    # tests/test_kernels.py::test_ssd_scan_sweep
         (2, 64, 3, 32, 16, 16),
         (2, 128, 2, 64, 64, 64)]


@pytest.mark.parametrize("b,t,h,p,n,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas(b, t, h, p, n, chunk, dtype):
    x, dt, a_log, bm, cm, h0 = scan_inputs(b, t, h, p, n, seed=b * 100 + t + n)
    (jx, tx), (jb, tb), (jc, tc) = (both(a, dtype) for a in (x, bm, cm))
    (jdt, tdt), (ja, ta), (jh, th) = both(dt), both(a_log), both(h0)
    y1, hf1 = jax_scan(jx, jdt, ja, jb, jc, jh, chunk=chunk)
    y2, hf2 = ssd_scan_ref(jx, jdt, ja, jb, jc, jh)
    before = ops.launches
    y, hf = ops.ssd_scan(tx, tdt, ta, tb, tc, th)
    assert ops.launches == before          # the CPU never counts a launch
    assert y.shape == (b, t, h, p) and y.dtype == tx.dtype
    assert hf.shape == (b, h, p, n) and hf.dtype == torch.float32
    for ref_y, ref_h in ((y1, hf1), (y2, hf2)):
        np.testing.assert_allclose(as_np(y), as_np(ref_y), **tol(dtype))
        np.testing.assert_allclose(as_np(hf), as_np(ref_h), **tol(dtype))


def test_ssd_scan_plain_ragged_t_matches_oracle_and_chunked_form():
    """T = 77 (the Pallas kernel needs T % chunk == 0; the port's kernel
    takes any T) against ``ssd_scan_ref`` and the reference model's own
    ``ssd_chunked`` (which pads T to its chunk)."""
    x, dt, a_log, bm, cm, h0 = scan_inputs(2, 77, 3, 32, 16, seed=77)
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc), (jh, th) = (
        both(a) for a in (x, dt, a_log, bm, cm, h0))
    y, hf = ops.ssd_scan(tx, tdt, ta, tb, tc, th)
    for ref_y, ref_h in (ssd_scan_ref(jx, jdt, ja, jb, jc, jh),
                         jm2.ssd_chunked(jx, jdt, ja, jb, jc, chunk=32, h0=jh)):
        np.testing.assert_allclose(as_np(y), as_np(ref_y), **tol("float32"))
        np.testing.assert_allclose(as_np(hf), as_np(ref_h), **tol("float32"))
    # the model's plain route and a None state
    y0, h_0 = tm2.ssd(tx, tdt, ta, tb, tc)
    jy0, jh_0 = jm2.ssd_chunked(jx, jdt, ja, jb, jc)
    np.testing.assert_allclose(y0.numpy(), as_np(jy0), **tol("float32"))
    np.testing.assert_allclose(h_0.numpy(), as_np(jh_0), **tol("float32"))


def test_ssd_scan_state_continuation_and_in_place_state():
    """Scanning [0:T] equals [0:T/2] then [T/2:T] with the carried state
    (the prefill -> decode handoff), ``h_out`` may be ``h0``, and one
    step at a time with an f32 y (as decode runs it) gives the same."""
    b, t, h, p, n = 1, 32, 2, 32, 16
    x, dt, a_log, bm, cm, h0 = (torch.from_numpy(a).float()
                                for a in scan_inputs(b, t, h, p, n, seed=5))
    y_full, h_full = ops.ssd_scan(x, dt, a_log, bm, cm, h0)
    m = t // 2
    y1, h1 = ops.ssd_scan(x[:, :m], dt[:, :m], a_log, bm[:, :m], cm[:, :m],
                          h0)
    state = h1.clone()
    y2, h2 = ops.ssd_scan(x[:, m:], dt[:, m:], a_log, bm[:, m:], cm[:, m:],
                          state, h_out=state)
    assert h2 is state
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), h_full.numpy(), atol=1e-5)
    state = h0.clone()
    ys = [ops.ssd_scan(x[:, i:i + 1], dt[:, i:i + 1], a_log, bm[:, i:i + 1],
                       cm[:, i:i + 1], state, h_out=state,
                       y_dtype=torch.float32)[0] for i in range(t)]
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), h_full.numpy(), atol=1e-5)


def test_ssd_scan_f32_y_is_the_unrounded_bf16_y():
    """With bf16 inputs, ``y_dtype=float32`` (a decode step's case) gives
    the y that the bf16 call rounds once."""
    x, dt, a_log, bm, cm, h0 = (torch.from_numpy(a).float()
                                for a in scan_inputs(2, 8, 2, 32, 16, seed=6))
    xb, bb, cb = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    y16, h16 = ops.ssd_scan(xb, dt, a_log, bb, cb, h0)
    y32, h32 = ops.ssd_scan(xb, dt, a_log, bb, cb, h0, y_dtype=torch.float32)
    assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
    assert torch.equal(y32.bfloat16(), y16) and torch.equal(h32, h16)


# --------------------------------------------------------------------------
# the chunked form (the kernel's body for bf16 with T >= CHUNKED_MIN_T):
# its plain version against the Pallas kernel, the oracle and the
# recurrence, at the reference's SSD bf16 tolerance (5e-2)
# --------------------------------------------------------------------------
CHUNKED = SWEEP + [(2, 77, 3, 32, 16, None), (1, 300, 2, 64, 64, None)]


@pytest.mark.parametrize("b,t,h,p,n,chunk", CHUNKED)
def test_ssd_scan_chunked_plain_matches_pallas_and_oracle(b, t, h, p, n, chunk):
    """bf16 x, B, C through ``ssd_scan_chunked_plain`` against the JAX
    ``ssd_scan`` (Pallas, interpret mode; it needs T % chunk == 0, so
    ragged T is held to the oracle alone) and ``ssd_scan_ref``."""
    x, dt, a_log, bm, cm, h0 = scan_inputs(b, t, h, p, n, seed=b * 100 + t + n)
    (jx, tx), (jb, tb), (jc, tc) = (both(a, "bfloat16") for a in (x, bm, cm))
    (jdt, tdt), (ja, ta), (jh, th) = both(dt), both(a_log), both(h0)
    y, hf = ops.ssd_scan_chunked_plain(tx, tdt, ta, tb, tc, th)
    assert y.shape == (b, t, h, p) and y.dtype == torch.bfloat16
    assert hf.shape == (b, h, p, n) and hf.dtype == torch.float32
    refs = [ssd_scan_ref(jx, jdt, ja, jb, jc, jh)]
    if chunk is not None:
        refs.append(jax_scan(jx, jdt, ja, jb, jc, jh, chunk=chunk))
    for ref_y, ref_h in refs:
        np.testing.assert_allclose(as_np(y), as_np(ref_y), **tol("bfloat16"))
        np.testing.assert_allclose(as_np(hf), as_np(ref_h), **tol("bfloat16"))


@pytest.mark.parametrize("b,t,h,p,n,chunk", CHUNKED)
@pytest.mark.parametrize("y_dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_chunked_plain_matches_the_recurrence(b, t, h, p, n, chunk,
                                                       y_dtype):
    """The chunked form against ``ssd_scan_plain`` (the recurrence that
    the CPU route and the kernel's short-T body run) on the same bf16
    inputs, y in bf16 (prefill) and f32."""
    x, dt, a_log, bm, cm, h0 = (torch.from_numpy(a).float() for a in
                                scan_inputs(b, t, h, p, n, seed=t + p))
    xb, bb, cb = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    y, hf = ops.ssd_scan_chunked_plain(xb, dt, a_log, bb, cb, h0,
                                       y_dtype=y_dtype)
    y_rec, h_rec = ops.ssd_scan_plain(xb, dt, a_log, bb, cb, h0,
                                      y_dtype=y_dtype)
    assert y.dtype == y_dtype
    np.testing.assert_allclose(as_np(y), as_np(y_rec), **tol("bfloat16"))
    np.testing.assert_allclose(hf.numpy(), h_rec.numpy(), **tol("bfloat16"))


@pytest.mark.parametrize("v", [0.0, -0.0, 1.0, -3.25, 1.0 + 2.0 ** -8,
                               1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -7 + 2.0 ** -15,
                               -(1.0 + 2.0 ** -9 + 2.0 ** -20), 0.1, 1e-30,
                               -3.0e38, 6.5e4 + 1.0 / 3.0])
def test_bf16_split_on_edge_values(v):
    """hi is v rounded to bf16 to nearest, ties to even (checked on the
    bits), lo is v - hi rounded the same way, and hi + lo is v to within
    2^-17 |v| (exactly when v has at most 16 significant bits)."""
    x = torch.tensor([v], dtype=torch.float32)
    hi, lo = ops.bf16_split(x)
    bits = int(x.view(torch.int32).item()) & 0xFFFFFFFF
    rne = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    expect = np.array([rne], dtype=np.uint32).view(np.float32)[0]
    assert hi.item() == expect and hi.dtype == torch.float32
    assert lo.item() == float(torch.tensor([v - hi.item()]).bfloat16().item())
    rest = abs(np.float64(v) - np.float64(hi.item()) - np.float64(lo.item()))
    assert rest <= 2.0 ** -17 * abs(np.float64(np.float32(v)))
    if v in (0.0, 1.0, -3.25, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
             1.0 + 2.0 ** -7 + 2.0 ** -15):
        assert hi.item() + lo.item() == np.float32(v)


@pytest.mark.parametrize("t,steps", [(16, 3), (77, 5), (130, 4)])
def test_ssd_scan_chunked_prefill_then_recurrence_decode(t, steps):
    """The kernel's hand-off: a chunked prefill (bf16, T >= CHUNKED_MIN_T)
    whose state feeds recurrence decode steps (T 1, y in f32, state in
    place), against the recurrence throughout."""
    total = t + steps
    x, dt, a_log, bm, cm, h0 = (torch.from_numpy(a).float() for a in
                                scan_inputs(2, total, 3, 32, 16, seed=total))
    xb, bb, cb = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    assert ops.takes_chunked_form(xb[:, :t])
    y_pre, state = ops.ssd_scan_chunked_plain(xb[:, :t], dt[:, :t], a_log,
                                              bb[:, :t], cb[:, :t], h0)
    ys = []
    for i in range(t, total):
        assert not ops.takes_chunked_form(xb[:, i:i + 1])
        ys.append(ops.ssd_scan_plain(xb[:, i:i + 1], dt[:, i:i + 1], a_log,
                                     bb[:, i:i + 1], cb[:, i:i + 1], state,
                                     h_out=state, y_dtype=torch.float32)[0])
    y_ref, h_ref = ops.ssd_scan_plain(xb, dt, a_log, bb, cb, h0,
                                      y_dtype=torch.float32)
    np.testing.assert_allclose(as_np(y_pre), as_np(y_ref[:, :t]),
                               **tol("bfloat16"))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(),
                               y_ref[:, t:].numpy(), **tol("bfloat16"))
    np.testing.assert_allclose(state.numpy(), h_ref.numpy(), **tol("bfloat16"))


# --------------------------------------------------------------------------
# the wrapper refuses what the kernel does not take
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["head_dim", "state_dim", "dt_dtype",
                                  "dt_shape", "a_log_shape", "dtype_mix",
                                  "y_dtype", "h0_dtype", "h_out_shape",
                                  "bc_shape", "noncontiguous"])
def test_ssd_check_rejects_what_the_kernel_does_not_take(case):
    b, t, h, p, n = 2, 5, 3, 64, 64
    x = torch.zeros(b, t, h, p)
    dt, a_log = torch.zeros(b, t, h), torch.zeros(h)
    bm, cm = torch.zeros(b, t, n), torch.zeros(b, t, n)
    h0, h_out = torch.zeros(b, h, p, n), torch.zeros(b, h, p, n)
    y_dtype = torch.float32
    if case == "head_dim":
        x = torch.zeros(b, t, h, 48)
        h0, h_out = torch.zeros(b, h, 48, n), torch.zeros(b, h, 48, n)
    elif case == "state_dim":
        bm, cm = torch.zeros(b, t, 8), torch.zeros(b, t, 8)
        h0, h_out = torch.zeros(b, h, p, 8), torch.zeros(b, h, p, 8)
    elif case == "dt_dtype":
        dt = dt.bfloat16()
    elif case == "dt_shape":
        dt = torch.zeros(b, t, h + 1)
    elif case == "a_log_shape":
        a_log = torch.zeros(h + 1)
    elif case == "dtype_mix":
        bm = bm.bfloat16()
    elif case == "y_dtype":
        y_dtype = torch.bfloat16                 # f32 x gives an f32 y
    elif case == "h0_dtype":
        h0 = h0.bfloat16()
    elif case == "h_out_shape":
        h_out = torch.zeros(b + 1, h, p, n)
    elif case == "bc_shape":
        cm = torch.zeros(b, t + 1, n)
    else:
        x = torch.zeros(b, h, t, p).transpose(1, 2)
    with pytest.raises(ValueError):
        ops._check(x, dt, a_log, bm, cm, h0, h_out, y_dtype)
    ops._check(torch.zeros(b, t, h, p), torch.zeros(b, t, h), torch.zeros(h),
               torch.zeros(b, t, n), torch.zeros(b, t, n),
               torch.zeros(b, h, p, n), torch.zeros(b, h, p, n),
               torch.float32)
    ops._check(torch.zeros(b, t, h, 32).bfloat16(), torch.zeros(b, t, h),
               torch.zeros(h), torch.zeros(b, t, 16).bfloat16(),
               torch.zeros(b, t, 16).bfloat16(), torch.zeros(b, h, 32, 16),
               torch.zeros(b, h, 32, 16), torch.float32)


def test_ssd_wrapper_refuses_a_device_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel (CUDA) or raises, never falls back."""
    x = torch.empty(1, 4, 2, 32, device="meta")
    dt = torch.empty(1, 4, 2, device="meta")
    a_log = torch.empty(2, device="meta")
    bc = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ssd_scan(x, dt, a_log, bc, bc)


# --------------------------------------------------------------------------
# the mixer against the reference
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reduced reference model with both kernel routes on, its
    params and the same params as numpy arrays."""
    cfg = routes(jax_config(ARCH), True)
    model = jax_build(cfg)
    params = model.init(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


def _mamba0(tree):
    return jax.tree.map(lambda a: a[0], tree["groups"][0]["mamba"])


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    w, di, n = cfg.ssm_conv_width, cfg.d_inner, cfg.ssm_state_dim
    return {"conv_x": rng.standard_normal((b, w - 1, di)).astype(np.float32),
            "conv_bc": rng.standard_normal((b, w - 1, 2 * n)).astype(np.float32),
            "h": (rng.standard_normal((b, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                       n)) * 0.1).astype(np.float32)}


def _check_state(tst, jst):
    for key in ("conv_x", "conv_bc", "h"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_mamba2_fwd_and_decode_match_reference(reference, with_state, kernel):
    _, _, tree = reference
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    params = params_from_jax(tree, cfg, device="cpu")["layers"][0]["mamba"]
    jp = _mamba0(tree)
    b, s = 2, 7
    x = np.random.default_rng(21 + with_state).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    state = _state(cfg, b, seed=22) if with_state else None
    jstate = None if state is None else jax.tree.map(jnp.asarray, state)
    tstate = None if state is None else {k: torch.from_numpy(v.copy())
                                         for k, v in state.items()}
    jy, jst = jm2.mamba2_fwd(jp, jnp.asarray(x), jcfg, jstate)
    ty, tst = tm2.mamba2_fwd(params, torch.from_numpy(x), cfg, tstate,
                             kernel=kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    _check_state(tst, jst)
    # a decode step from that state, and from a fresh one
    state = _state(cfg, b, seed=23)
    for jsrc, tsrc in ((jst, tst),
                       (jax.tree.map(jnp.asarray, state),
                        {k: torch.from_numpy(v.copy())
                         for k, v in state.items()})):
        xt = np.random.default_rng(24).standard_normal(
            (b, 1, cfg.d_model)).astype(np.float32)
        jy, jnew = jm2.mamba2_decode(jp, jnp.asarray(xt), jcfg, jsrc)
        ty, tnew = tm2.mamba2_decode(params, torch.from_numpy(xt), cfg, tsrc,
                                     kernel=kernel)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        _check_state(tnew, jnew)


def test_mamba2_decode_writes_its_state_in_place(reference):
    """With ``out``, the new conv windows and SSD state land in the given
    tensors, which may be the input state's (a decode step's cache)."""
    _, _, tree = reference
    cfg = get_config(ARCH)
    params = params_from_jax(tree, cfg, device="cpu")["layers"][0]["mamba"]
    state = {k: torch.from_numpy(v) for k, v in _state(cfg, 2, 25).items()}
    fresh = {k: v.clone() for k, v in state.items()}
    x = torch.from_numpy(np.random.default_rng(26).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    y_ref, st_ref = tm2.mamba2_decode(params, x, cfg, fresh)
    y, st = tm2.mamba2_decode(params, x, cfg, state, kernel=True, out=state)
    for key in ("conv_x", "conv_bc", "h"):
        assert st[key] is state[key]
        assert torch.equal(state[key], st_ref[key]), key
    assert torch.equal(y, y_ref)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(27)
    x = rng.standard_normal((2, 6, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = jm2._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if state is None else jnp.asarray(state))
        ty, ts = tm2._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  None if state is None
                                  else torch.from_numpy(state))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --------------------------------------------------------------------------
# the reduced model: prefill + decode past the window against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("b,s", [(2, 20), (1, 9)])
def test_prefill_and_decode_match_reference(reference, kernel_route, b, s):
    """The shared block's window is 16 in the reduced cut: a prompt of 20
    wraps its ring buffer in prefill, one of 9 wraps it while decoding."""
    jmodel, jparams, tree = reference
    cfg = routes(get_config(ARCH), kernel_route)
    assert cfg.shared_attn_window == 16 and cfg.shared_attn_every == 1
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(b * 100 + s)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    cache_len = s + 12
    jl, jc = jmodel.prefill(jparams, {"tokens": toks}, cache_len=cache_len)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache_len=cache_len)

    def same_cache(tc, jc):
        _check_state(tc["ssm"], jc["groups"][0]["ssm"])
        for key in ("k", "v"):
            np.testing.assert_allclose(tc["shared"][key].numpy(),
                                       np.asarray(jc["shared"][key]),
                                       atol=ATOL, err_msg=f"shared.{key}")

    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    same_cache(tc, jc)
    assert tc["index"].shape == () and tc["index"].dtype == torch.int32
    assert int(tc["index"]) == int(jc["index"]) == s
    assert set(tc) == {"ssm", "shared", "index"}
    assert tc["shared"]["k"].shape == (2, b, 16, cfg.num_kv_heads,
                                       cfg.head_dim)
    h = tc["ssm"]["h"]
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
    for step in range(max(3, 17 - s)):           # past the 16-slot window
        jl, jc = jmodel.decode_step(jparams, jc, tok[:, None])
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None])
        assert tc["ssm"]["h"] is h                # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        same_cache(tc, jc)
        assert tc["index"].shape == () and tc["index"].dtype == torch.int32
        assert int(tc["index"]) == int(jc["index"]) == s + step + 1
        assert np.array_equal(tl[:, :cfg.vocab_size].argmax(-1).numpy(),
                              np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1))
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------
def test_full_width_zamba2_is_the_published_shape():
    cfg = get_config("zamba2-2.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_num_heads,
            cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_conv_width) == \
        (54, 2560, 5120, 80, 64, 64, 4)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size) == (32, 32, 80, 10240, 32000)
    assert cfg.blocks == ("mamba2+none",) * 54
    assert (cfg.shared_attn_every, cfg.shared_attn_window) == (6, 4096)
    assert cfg.tie_embeddings and cfg.rope_kind == "standard"
    assert cfg.mlp_kind == "swiglu"
    assert cfg.dtype == cfg.param_dtype == "bfloat16"
    assert build_model(cfg, device="cpu").cfg is cfg
    red = get_config(ARCH)
    assert (red.num_layers, red.d_model, red.ssm_num_heads, red.ssm_head_dim,
            red.ssm_state_dim, red.head_dim, red.shared_attn_every,
            red.shared_attn_window, red.dtype) == (2, 256, 16, 32, 16, 64, 1,
                                                   16, "float32")


def test_decode_cache_has_the_reference_layout_in_bf16():
    """At a bf16 compute dtype, the Mamba2 state and the shared block's
    ring buffers have the reference's shapes and dtypes (the reference's
    per-layer state stacked over layers, its ``cache["shared"]`` as it
    is); the SSD state stays f32."""
    jcfg = dataclasses.replace(jax_config(ARCH), dtype="bfloat16",
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(ARCH), dtype="bfloat16",
                              param_dtype="bfloat16")
    jcache = jax.eval_shape(lambda: jax_build(jcfg).init_cache(3, 24))
    tcache = build_model(cfg, device="cpu").init_cache(3, 24)
    for part, jpart in ((tcache["ssm"], jcache["groups"][0]["ssm"]),
                        (tcache["shared"], jcache["shared"])):
        assert set(part) == set(jpart)
        for k, v in part.items():
            assert (str(v.dtype).replace("torch.", ""), tuple(v.shape)) == \
                (jpart[k].dtype.name, tuple(jpart[k].shape)), k
    assert tcache["ssm"]["h"].dtype == torch.float32
    assert tcache["shared"]["k"].shape == (2, 3, 16, cfg.num_kv_heads,
                                           cfg.head_dim)
