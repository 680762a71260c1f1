"""The port's RWKV-6 path against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
The port's ``rwkv6_scan`` wrapper takes its plain PyTorch version for CPU
tensors (the CUDA kernel runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against the same plain version
there); the JAX side runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does, or its pure-jnp oracle.  Tolerances:
f32 2e-5 and bf16 2e-2 (absolute and relative) for the kernel, as the
repo's; atol 1e-4 for the model, as ``tests/test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.rwkv6_scan.ops import rwkv6_scan as jax_scan
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro.models import build_model as jax_build
from repro.models import rwkv6 as jrk
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import rwkv6 as trk
from repro_torch.utils import counters

ATOL = 1e-4
ARCH = "rwkv6-1.6b-reduced"
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


def scan_inputs(b, t, h, d, seed, lo=0.8):
    """r, k, v, w, u, s0 as numpy arrays, scaled as tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, d)) * 0.5 for _ in range(3))
    w = rng.uniform(lo, 0.999, (b, t, h, d))
    u = rng.standard_normal((h, d)) * 0.5
    s0 = rng.standard_normal((b, h, d, d)) * 0.1
    return r, k, v, w, u, s0


def routes(cfg, on: bool):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


# --------------------------------------------------------------------------
# the WKV6 scan: plain version vs the Pallas kernel and its oracle
# --------------------------------------------------------------------------
SWEEP = [(1, 16, 1, 16, 8),       # tests/test_kernels.py::test_rwkv6_scan_sweep
         (2, 64, 3, 32, 16),
         (2, 32, 2, 64, 32)]


@pytest.mark.parametrize("b,t,h,d,block_t", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bfloat16-w32"])
def test_rwkv6_scan_plain_matches_pallas(b, t, h, d, block_t, dtype):
    """``bfloat16-w32`` is the serving path's case: r/k/v in bf16, the
    decay in f32 (the reference's Pallas kernel is fed the same)."""
    name = dtype[:8] if dtype != "float32" else dtype
    r, k, v, w, u, s0 = scan_inputs(b, t, h, d, seed=b * 100 + t + d)
    (jr, tr), (jk, tk), (jv, tv) = both(r, name), both(k, name), both(v, name)
    (jw, tw) = both(w, "float32" if dtype == "bfloat16-w32" else name)
    (ju, tu), (js, ts) = both(u), both(s0)
    y1, sf1 = jax_scan(jr, jk, jv, jw, ju, js, block_t=block_t)
    y2, sf2 = rwkv6_scan_ref(jr, jk, jv, jw, ju, js)
    before = counters.read()["rwkv6_scan"]
    y, sf = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts)
    # the CPU never counts a launch
    assert counters.read()["rwkv6_scan"] == before
    assert y.shape == (b, t, h, d) and y.dtype == tr.dtype
    assert sf.shape == (b, h, d, d) and sf.dtype == torch.float32
    for ref_y, ref_s in ((y1, sf1), (y2, sf2)):
        np.testing.assert_allclose(as_np(y), as_np(ref_y), **tol(name))
        np.testing.assert_allclose(as_np(sf), as_np(ref_s), **tol(name))


def test_rwkv6_scan_plain_ragged_t_matches_oracle_and_model_scan():
    """T = 77 (the Pallas kernel needs T % block_t == 0; the port's
    kernel takes any T) against ``rwkv6_scan_ref`` and the reference
    model's own ``wkv6_scan``."""
    r, k, v, w, u, s0 = scan_inputs(2, 77, 3, 32, seed=77)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw) = (both(a) for a in (r, k, v, w))
    (ju, tu), (js, ts) = both(u), both(s0)
    y, sf = ops.rwkv6_scan(tr, tk, tv, tw, tu, ts)
    for ref_y, ref_s in (rwkv6_scan_ref(jr, jk, jv, jw, ju, js),
                         jrk.wkv6_scan(jr, jk, jv, jw, ju, js)):
        np.testing.assert_allclose(as_np(y), as_np(ref_y), **tol("float32"))
        np.testing.assert_allclose(as_np(sf), as_np(ref_s), **tol("float32"))
    # the model's plain route and a None state
    y0, s_0 = trk.wkv6_scan(tr, tk, tv, tw, tu)
    jy0, js_0 = jrk.wkv6_scan(jr, jk, jv, jw, ju)
    np.testing.assert_allclose(y0.numpy(), as_np(jy0), **tol("float32"))
    np.testing.assert_allclose(s_0.numpy(), as_np(js_0), **tol("float32"))


def test_rwkv6_scan_state_continuation_and_in_place_state():
    """Scanning [0:T] equals [0:T/2] then [T/2:T] with the carried state
    (the prefill -> decode handoff), and ``s_out`` may be ``s0``."""
    b, t, h, d = 1, 32, 2, 16
    r, k, v, w, u, s0 = (torch.from_numpy(a).float()
                         for a in scan_inputs(b, t, h, d, seed=5, lo=0.9))
    y_full, s_full = ops.rwkv6_scan(r, k, v, w, u, s0)
    m = t // 2
    y1, s1 = ops.rwkv6_scan(r[:, :m], k[:, :m], v[:, :m], w[:, :m], u, s0)
    state = s1.clone()
    y2, s2 = ops.rwkv6_scan(r[:, m:], k[:, m:], v[:, m:], w[:, m:], u,
                            state, s_out=state)
    assert s2 is state
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), atol=1e-5)
    # one step at a time, as decode runs it
    state = s0.clone()
    ys = [ops.rwkv6_scan(r[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1],
                         w[:, i:i + 1], u, state, s_out=state)[0]
          for i in range(t)]
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), atol=1e-5)


def test_rwkv6_scan_widens_a_bf16_decay_exactly():
    r, k, v, w, u, s0 = (torch.from_numpy(a).float()
                         for a in scan_inputs(2, 8, 2, 16, seed=6))
    wb = w.bfloat16()
    y, s = ops.rwkv6_scan(r, k, v, wb, u, s0)
    y_ref, s_ref = ops.rwkv6_scan_plain(r, k, v, wb.float(), u, s0)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)


# --------------------------------------------------------------------------
# the wrapper refuses what the kernel does not take
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["u_dtype", "s0_dtype", "head_dim", "shape",
                                  "w_shape", "u_shape", "dtype_mix",
                                  "s_out_shape", "noncontiguous"])
def test_rwkv6_check_rejects_what_the_kernel_does_not_take(case):
    b, t, h, d = 2, 5, 3, 64
    r = torch.zeros(b, t, h, d)
    k, v, w = torch.zeros_like(r), torch.zeros_like(r), torch.zeros_like(r)
    u, s0 = torch.zeros(h, d), torch.zeros(b, h, d, d)
    s_out = torch.zeros_like(s0)
    if case == "u_dtype":
        u = u.bfloat16()
    elif case == "s0_dtype":
        s0 = s0.bfloat16()
    elif case == "head_dim":
        r, k, v, w = (torch.zeros(b, t, h, 48) for _ in range(4))
        u, s0, s_out = torch.zeros(h, 48), torch.zeros(b, h, 48, 48), \
            torch.zeros(b, h, 48, 48)
    elif case == "shape":
        k = torch.zeros(b, t + 1, h, d)
    elif case == "w_shape":
        w = torch.zeros(b, t, h + 1, d)
    elif case == "u_shape":
        u = torch.zeros(h + 1, d)
    elif case == "dtype_mix":
        k = k.bfloat16()
    elif case == "s_out_shape":
        s_out = torch.zeros(b + 1, h, d, d)
    else:
        r = torch.zeros(b, h, t, d).transpose(1, 2)
    with pytest.raises(ValueError):
        ops._check(r, k, v, w, u, s0, s_out)
    ops._check(*(torch.zeros(b, t, h, d) for _ in range(4)),
               torch.zeros(h, d), torch.zeros(b, h, d, d),
               torch.zeros(b, h, d, d))


def test_rwkv6_wrapper_refuses_a_device_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel (CUDA) or raises, never falls back."""
    x = torch.empty(1, 4, 2, 16, device="meta")
    u = torch.empty(2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rwkv6_scan(x, x, x, x, u)


# --------------------------------------------------------------------------
# time mix and channel mix against the reference
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reduced reference model with both kernel routes on, its
    params and the same params as numpy arrays."""
    cfg = routes(jax_config(ARCH), True)
    model = jax_build(cfg)
    params = model.init(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


def _layer0(tree, name):
    return jax.tree.map(lambda a: a[0], tree["groups"][0][name])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_time_and_channel_mix_match_reference(reference, with_state, kernel):
    _, _, tree = reference
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    ptm, pcm = ({k: torch.from_numpy(np.array(v))
                 for k, v in _layer0(tree, name).items()}
                for name in ("tmix", "cmix"))
    rng = np.random.default_rng(11 + with_state)
    b, s, d = 2, 7, cfg.d_model
    h = cfg.rwkv_num_heads
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    state = None
    if with_state:
        state = {"shift": rng.standard_normal((b, d)).astype(np.float32),
                 "wkv": (rng.standard_normal((b, h, 64, 64)) * 0.1)
                 .astype(np.float32)}
    jstate = None if state is None else jax.tree.map(jnp.asarray, state)
    tstate = None if state is None else {k: torch.from_numpy(v.copy())
                                         for k, v in state.items()}
    jy, jst = jrk.rwkv6_tmix_fwd(_layer0(tree, "tmix"), jnp.asarray(x), jcfg,
                                 jstate)
    ty, tst = trk.rwkv6_tmix_fwd(ptm, torch.from_numpy(x), cfg, tstate,
                                 kernel=kernel)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for key in ("shift", "wkv"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   atol=ATOL)
    cstate = None if state is None else {"shift": state["shift"]}
    jy, jst = jrk.rwkv6_cmix_fwd(_layer0(tree, "cmix"), jnp.asarray(x), jcfg,
                                 None if cstate is None else
                                 jax.tree.map(jnp.asarray, cstate))
    ty, tst = trk.rwkv6_cmix_fwd(pcm, torch.from_numpy(x), cfg,
                                 None if cstate is None else
                                 {"shift": torch.from_numpy(cstate["shift"])})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tst["shift"].numpy(), np.asarray(jst["shift"]),
                               atol=ATOL)


def test_time_mix_writes_its_state_in_place(reference):
    """With ``out``, the new shift and WKV state land in the given
    tensors, which may be the input state's (a decode step's cache)."""
    _, _, tree = reference
    cfg = get_config(ARCH)
    p = {k: torch.from_numpy(np.array(v))
         for k, v in _layer0(tree, "tmix").items()}
    rng = np.random.default_rng(12)
    b, d, h = 2, cfg.d_model, cfg.rwkv_num_heads
    x = torch.from_numpy(rng.standard_normal((b, 1, d)).astype(np.float32))
    state = {"shift": torch.from_numpy(rng.standard_normal((b, d))
                                       .astype(np.float32)),
             "wkv": torch.zeros(b, h, 64, 64)}
    fresh = {k: v.clone() for k, v in state.items()}
    y_ref, st_ref = trk.rwkv6_tmix_fwd(p, x, cfg, fresh)
    y, st = trk.rwkv6_tmix_fwd(p, x, cfg, state, kernel=True, out=state)
    assert st["wkv"] is state["wkv"] and st["shift"] is state["shift"]
    assert torch.equal(y, y_ref)
    assert torch.equal(state["wkv"], st_ref["wkv"])
    assert torch.equal(state["shift"], x[:, -1])


# --------------------------------------------------------------------------
# the reduced model: prefill + decode against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("b,s", [(2, 16), (1, 9)])
def test_prefill_and_decode_match_reference(reference, kernel_route, b, s):
    jmodel, jparams, tree = reference
    cfg = routes(get_config(ARCH), kernel_route)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(b * 100 + s)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": toks}, cache_len=s + 4)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache_len=s + 4)

    def same_state(tc, jc):
        g = jc["groups"][0]
        for part, key in (("tmix", "shift"), ("tmix", "wkv"),
                          ("cmix", "shift")):
            np.testing.assert_allclose(tc[part][key].numpy(),
                                       np.asarray(g[part][key]), atol=ATOL,
                                       err_msg=f"{part}.{key}")

    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    same_state(tc, jc)
    assert tc["index"].shape == () and tc["index"].dtype == torch.int32
    assert int(tc["index"]) == int(jc["index"]) == s
    assert set(tc) == {"tmix", "cmix", "index"}
    assert tc["tmix"]["wkv"].dtype == torch.float32
    wkv = tc["tmix"]["wkv"]
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
    for step in range(3):
        jl, jc = jmodel.decode_step(jparams, jc, tok[:, None])
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None])
        assert tc["tmix"]["wkv"] is wkv           # updated in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        same_state(tc, jc)
        assert tc["index"].shape == () and tc["index"].dtype == torch.int32
        assert int(tc["index"]) == int(jc["index"]) == s + step + 1
        assert np.array_equal(tl[:, :cfg.vocab_size].argmax(-1).numpy(),
                              np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1))
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------
def test_full_width_rwkv6_is_the_published_shape():
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.num_layers, cfg.d_model, cfg.rwkv_num_heads, cfg.d_ff,
            cfg.vocab_size) == (24, 2048, 32, 7168, 65536)
    assert cfg.d_model // cfg.rwkv_num_heads == 64
    assert cfg.blocks == ("rwkv6+rwkv_cm",) * 24
    assert not cfg.tie_embeddings and cfg.rope_kind == "none"
    assert cfg.dtype == cfg.param_dtype == "bfloat16"
    red = get_config(ARCH)
    assert (red.num_layers, red.d_model, red.rwkv_num_heads, red.d_ff,
            red.vocab_size, red.dtype) == (2, 256, 4, 512, 1024, "float32")


def _leaves(tree, prefix=""):
    """{path: (dtype name, shape)} of a nested dict of arrays/tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            dt = str(v.dtype).replace("torch.", "")
            out[prefix + k] = (dt, tuple(v.shape))
    return out


@pytest.mark.parametrize("arch", [ARCH, "smollm-135m-reduced",
                                  "zamba2-2.7b-reduced"])
def test_leaf_dtypes_and_shapes_match_the_reference_in_bf16(arch):
    """At a bf16 param dtype, every leaf of ``init_params`` and of
    ``params_from_jax`` has the reference's dtype and shape: RWKV-6's
    f32 leaves (decay base, bonus, group-norm affine) and Mamba2's (dt
    bias, a_log, D-skip) stay f32, and zamba2's shared block is one
    weight set with no layer axis."""
    jcfg = dataclasses.replace(jax_config(arch), dtype="bfloat16",
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                              param_dtype="bfloat16")
    jmodel = jax_build(jcfg)
    spec = jax.eval_shape(jmodel.init, jax.random.key(0))
    stacked = spec["groups"][0]
    ref = _leaves({k: v for k, v in spec.items() if k != "groups"})
    layer_ref = {k: (dt, shape[1:])
                 for k, (dt, shape) in _leaves(stacked).items()}
    model = build_model(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))
    for params in (model.init(model.generator(0)),
                   params_from_jax(tree, cfg, device="cpu")):
        assert _leaves({k: v for k, v in params.items()
                        if k != "layers"}) == ref
        assert len(params["layers"]) == cfg.num_layers
        for layer in params["layers"]:
            assert _leaves(layer) == layer_ref
    if arch == ARCH:
        assert layer_ref["tmix.bonus_u"][0] == "float32"
        assert layer_ref["tmix.w_r"][0] == "bfloat16"
    if arch == "zamba2-2.7b-reduced":
        assert layer_ref["mamba.a_log"][0] == "float32"
        assert layer_ref["mamba.w_zx"][0] == "bfloat16"
        assert "shared_attn.attn.wq" in ref and "norm2" not in layer_ref
