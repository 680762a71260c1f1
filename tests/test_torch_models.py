"""The port's dense model against the JAX package's, on the CPU.

The reference runs ``smollm-135m-reduced`` in f32 with its Pallas
kernel routes on (interpret mode); the port loads the same weights
through ``params_from_jax`` and runs its plain PyTorch routes.  Inputs
are drawn with numpy from a seed.  Tolerance: atol 1e-4, as the
reference's own ``test_pallas_prefill_route_matches_jnp_path``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm

ATOL = 1e-4
ARCH = "smollm-135m-reduced"


def routes(cfg, on: bool):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


@pytest.fixture(scope="module")
def reference():
    """The reference model with both kernel routes on, its params and
    the same params as numpy arrays."""
    cfg = routes(jax_config(ARCH), True)
    model = jax_build(cfg)
    params = model.init(jax.random.key(0))
    return model, params, jax.tree.map(np.asarray, params)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["smollm-135m", "smollm-135m-reduced",
                                  "rwkv6-1.6b", "rwkv6-1.6b-reduced",
                                  "zamba2-2.7b", "zamba2-2.7b-reduced"])
def test_config_maps_field_for_field(arch):
    ref, port = jax_config(arch), get_config(arch)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert port.padded_vocab == ref.padded_vocab
    assert (port.d_inner, port.ssm_num_heads) == (ref.d_inner,
                                                  ref.ssm_num_heads)


def test_full_width_smollm_is_the_published_shape():
    cfg = get_config("smollm-135m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (30, 576, 9, 3, 64,
                                                        1536, 49152)
    assert cfg.blocks == ("attn+mlp",) * 30 and cfg.tie_embeddings
    assert cfg.dtype == cfg.param_dtype == "bfloat16"
    with pytest.raises(KeyError):
        get_config("gemma-2b")


# --------------------------------------------------------------------------
# numerics of the building blocks
# --------------------------------------------------------------------------
def test_rms_norm_linear_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tcommon.rms_norm(t(x), t(scale), 1e-5).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        atol=1e-6)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.linear(t(x), t(w)).numpy(),
        np.asarray(jcommon.linear(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-5)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.apply_rope(t(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0)),
        atol=1e-5)


def test_linear_keeps_bf16_and_rounds_once():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    out = tcommon.linear(t(x).bfloat16(), t(w).bfloat16())
    ref = jcommon.linear(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_swiglu_mlp_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    out = tmlp.mlp_fwd({k: t(v) for k, v in p.items()}, t(x), "swiglu")
    ref = jmlp.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), "swiglu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kernel_route", [True, False])
def test_attention_decode_matches_reference(kernel_route):
    cfg = routes(get_config(ARCH), kernel_route)
    jcfg = routes(jax_config(ARCH), kernel_route)
    rng = np.random.default_rng(3)
    dm, h, kv, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": (dm, h * d), "wk": (dm, kv * d), "wv": (dm, kv * d),
         "wo": (h * d, dm)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in p.items()}
    b, s_cache, index = 2, 12, 7
    x = rng.standard_normal((b, 1, dm)).astype(np.float32)
    ck = rng.standard_normal((b, s_cache, kv, d)).astype(np.float32)
    cv = rng.standard_normal((b, s_cache, kv, d)).astype(np.float32)
    pos = np.full((b, 1), index, np.int32)
    y_ref, c_ref = jattn.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.int32(index),
        jnp.asarray(pos), jcfg)
    cache = {"k": t(ck), "v": t(cv)}
    y, c = tattn.attention_decode({k: t(v) for k, v in p.items()}, t(x),
                                  cache, index, torch.from_numpy(pos), cfg)
    assert c["k"] is cache["k"]               # updated in place
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(c_ref["k"]), atol=1e-5)
    np.testing.assert_allclose(c["v"].numpy(), np.asarray(c_ref["v"]), atol=1e-5)


# --------------------------------------------------------------------------
# the sliding-window ring buffer (zamba2's shared block) at head_dim 80
# --------------------------------------------------------------------------
RING = dict(dm=48, h=2, kv=2, d=80, window=8)


def _ring_cfgs(kernel_route):
    """A reduced dense config at head_dim 80 for both packages."""
    change = dict(d_model=RING["dm"], num_heads=RING["h"],
                  num_kv_heads=RING["kv"], head_dim=RING["d"])
    return (routes(dataclasses.replace(get_config(ARCH), **change),
                   kernel_route),
            routes(dataclasses.replace(jax_config(ARCH), **change),
                   kernel_route))


def _ring_params(rng):
    dm, h, kv, d = RING["dm"], RING["h"], RING["kv"], RING["d"]
    p = {"wq": (dm, h * d), "wk": (dm, kv * d), "wv": (dm, kv * d),
         "wo": (h * d, dm)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in p.items()}


@pytest.mark.parametrize("s,cache_len", [(5, 20), (13, 20), (8, 6)])
def test_write_kv_cache_ring_matches_reference(s, cache_len):
    """Prefill's K/V into a ring buffer of min(window, cache_len) slots,
    before and after the prompt wraps it (window 8)."""
    rng = np.random.default_rng(s + cache_len)
    b, kv, d, w = 2, RING["kv"], RING["d"], RING["window"]
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ref = jtfm._write_kv_cache(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), cache_len, w)
    cfg, _ = _ring_cfgs(False)
    cache = {n: c[0] for n, c in tattn.init_attention_cache(
        cfg, b, cache_len, torch.float32, "cpu", window=w).items()}
    assert cache["k"].shape == ref["k"].shape == (b, min(w, cache_len), kv, d)
    ttfm._write_kv_cache(t(k), t(v), cache, w)
    for n in ("k", "v"):
        np.testing.assert_array_equal(cache[n].numpy(), np.asarray(ref[n]))


@pytest.mark.parametrize("kernel_route", [True, False])
def test_attention_decode_ring_matches_reference_across_the_wrap(kernel_route):
    """Decode steps into an 8-slot ring buffer from index 3 to 12: the
    reference's masked route (its kernel route is never taken for a
    window) against the port's kernel route (lengths = min(index + 1,
    S)) and its masked route."""
    cfg, jcfg = _ring_cfgs(kernel_route)
    rng = np.random.default_rng(4)
    p = _ring_params(rng)
    b, kv, d, w = 2, RING["kv"], RING["d"], RING["window"]
    ck = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    cv = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    cache = {"k": t(ck), "v": t(cv)}
    for index in range(3, 13):
        x = rng.standard_normal((b, 1, RING["dm"])).astype(np.float32)
        pos = np.full((b, 1), index, np.int32)
        y_ref, jcache = jattn.attention_decode(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcache,
            jnp.int32(index), jnp.asarray(pos), jcfg, window=w)
        y, c = tattn.attention_decode({k: t(v) for k, v in p.items()}, t(x),
                                      cache, index, torch.from_numpy(pos),
                                      cfg, window=w)
        assert c["k"] is cache["k"]               # updated in place
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n].numpy(),
                                       np.asarray(jcache[n]), atol=1e-6)


def test_ring_lengths_route_equals_the_masked_route():
    """For every index before, at and after the wrap, the kernel route's
    contiguous mask ``j < min(index + 1, S)`` keeps exactly the slots of
    the reference's ring mask ``(index % S - j) % S <= index``, and the
    two routes give the same output."""
    s_cache = 8
    j = torch.arange(s_cache)
    for index in range(3 * s_cache):
        ring = (index % s_cache - j) % s_cache <= index
        assert torch.equal(ring, j < min(index + 1, s_cache)), index
    on, _ = _ring_cfgs(True)
    off, _ = _ring_cfgs(False)
    rng = np.random.default_rng(5)
    p = {k: t(v) for k, v in _ring_params(rng).items()}
    b, kv, d = 2, RING["kv"], RING["d"]
    ck = t(rng.standard_normal((b, s_cache, kv, d)))
    cv = t(rng.standard_normal((b, s_cache, kv, d)))
    for index in (0, 5, 7, 8, 15, 21):
        x = t(rng.standard_normal((b, 1, RING["dm"])))
        pos = torch.full((b, 1), index, dtype=torch.long)
        outs = []
        for cfg in (on, off):
            cache = {"k": ck.clone(), "v": cv.clone()}
            outs.append(tattn.attention_decode(p, x, cache, index, pos, cfg,
                                               window=s_cache)[0])
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                                   atol=1e-6)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def test_init_params_has_the_reference_layout(reference):
    _, _, tree = reference
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    assert params["embed"].shape == tree["embed"].shape
    assert params["final_norm"].shape == tree["final_norm"].shape
    assert len(params["layers"]) == cfg.num_layers

    def shapes(tr, lead=0):
        return {k: shapes(v, lead) if isinstance(v, dict)
                else tuple(v.shape[lead:]) for k, v in tr.items()}

    for layer in params["layers"]:
        assert shapes(layer) == shapes(tree["groups"][0], lead=1)
    w = params["layers"][0]["attn"]["wq"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    again = model.init(model.generator(0))
    assert torch.equal(again["layers"][1]["mlp"]["w_up"],
                       params["layers"][1]["mlp"]["w_up"])


def test_params_from_jax_unstacks_layers(reference):
    _, _, tree = reference
    cfg = get_config(ARCH)
    params = params_from_jax(tree, cfg, device="cpu")
    stacked = tree["groups"][0]
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wk"].numpy(),
                                      stacked["attn"]["wk"][i])
        np.testing.assert_array_equal(layer["mlp"]["w_down"].numpy(),
                                      stacked["mlp"]["w_down"][i])
        np.testing.assert_array_equal(layer["norm2"].numpy(),
                                      stacked["norm2"][i])
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])


# --------------------------------------------------------------------------
# prefill + decode against the reference
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
    cache_len = s + 4
    jl, jc = jmodel.prefill(jparams, {"tokens": toks}, cache_len=cache_len)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jkv = jc["groups"][0]["kv"]
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jkv["k"]), atol=ATOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jkv["v"]), atol=ATOL)
    assert tc["index"].shape == () and tc["index"].dtype == torch.int32
    assert int(tc["index"]) == int(jc["index"]) == s
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
    for step in range(3):
        jl, jc = jmodel.decode_step(jparams, jc, tok[:, None])
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert tc["index"].shape == () and tc["index"].dtype == torch.int32
        assert int(tc["index"]) == int(jc["index"]) == s + step + 1
        assert np.array_equal(tl[:, :cfg.vocab_size].argmax(-1).numpy(),
                              np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1))
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
    jkv = jc["groups"][0]["kv"]
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jkv["v"]), atol=ATOL)


# --------------------------------------------------------------------------
# devices and what is not ported
# --------------------------------------------------------------------------
def test_build_model_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.resolve_device("cuda")
    assert build_model(get_config(ARCH), device="cpu").device.type == "cpu"


def test_unported_configs_are_refused():
    cfg = get_config(ARCH)
    n = cfg.num_layers
    for change in (dict(blocks=("swa+mlp",) * n, window_size=8),
                   dict(rope_kind="mrope"), dict(logit_softcap=30.0),
                   dict(mlp_kind="gelu"),
                   dict(blocks=("attn+moe",) * n),
                   dict(blocks=("rwkv6+mlp",) * n, rope_kind="none"),
                   dict(blocks=("attn+mlp", "rwkv6+rwkv_cm")),
                   dict(blocks=("rwkv6+rwkv_cm",) * n),   # with RoPE
                   dict(blocks=("rwkv6+rwkv_cm",) * n, rope_kind="none",
                        logit_softcap=30.0)):
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(cfg, **change), device="cpu")
