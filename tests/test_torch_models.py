"""The port's dense models against the JAX package's, on the CPU.

The reference runs the reduced dense cuts (``smollm-135m-reduced``,
``gemma-2b-reduced``, ``h2o-danube-1.8b-reduced``, and a gemma cut at
its full head_dim 256 over 8 query heads and 1 KV head) in f32 with its
Pallas kernel routes on (interpret mode); the port loads the same
weights through ``params_from_jax`` and runs its plain PyTorch routes.
Inputs are drawn with numpy from a seed.  Tolerances: atol 1e-4 for
prefill and decode, as the reference's own
``test_pallas_prefill_route_matches_jnp_path``; 1e-5 for the MLPs and
2e-5 for the blocked attention; the no-cache ``forward`` against
prefill plus decode at the reference's own 2e-2 / 3e-2
(``tests/test_models.py``).
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
# gemma-2b-reduced at gemma's own attention widths: head_dim 256, 8 query
# heads over 1 KV head (the reduced cut has 4 heads of 64)
GEMMA_D256 = "gemma-2b-reduced-d256"
DENSE = (ARCH, "smollm-360m-reduced", "gemma-2b-reduced",
         "h2o-danube-1.8b-reduced")
PORTED = DENSE + ("rwkv6-1.6b-reduced", "zamba2-2.7b-reduced")


def routes(cfg, on: bool):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


def configs(arch):
    """The port's and the reference's config of ``arch`` (or of the
    ``GEMMA_D256`` cut)."""
    if arch == GEMMA_D256:
        change = dict(head_dim=256, num_heads=8, num_kv_heads=1)
        return (dataclasses.replace(get_config("gemma-2b-reduced"), **change),
                dataclasses.replace(jax_config("gemma-2b-reduced"), **change))
    return get_config(arch), jax_config(arch)


_REFS = {}


def reference_of(arch):
    """The reference model of ``arch`` with both kernel routes on, its
    key(0) params and the same params as numpy arrays."""
    if arch not in _REFS:
        model = jax_build(routes(configs(arch)[1], True))
        params = model.init(jax.random.key(0))
        _REFS[arch] = (model, params, jax.tree.map(np.asarray, params))
    return _REFS[arch]


@pytest.fixture(scope="module")
def reference():
    """``reference_of(ARCH)``."""
    return reference_of(ARCH)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["smollm-135m", "smollm-135m-reduced",
                                  "rwkv6-1.6b", "rwkv6-1.6b-reduced",
                                  "zamba2-2.7b", "zamba2-2.7b-reduced",
                                  "smollm-360m", "smollm-360m-reduced",
                                  "gemma-2b", "gemma-2b-reduced",
                                  "h2o-danube-1.8b",
                                  "h2o-danube-1.8b-reduced"])
def test_config_maps_field_for_field(arch):
    ref, port = jax_config(arch), get_config(arch)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert port.padded_vocab == ref.padded_vocab
    assert (port.d_inner, port.ssm_num_heads) == (ref.d_inner,
                                                  ref.ssm_num_heads)
    assert port.mixer_kinds == ref.mixer_kinds
    assert port.param_count() == ref.param_count() > 0


def test_full_width_smollm_is_the_published_shape():
    cfg = get_config("smollm-135m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (30, 576, 9, 3, 64,
                                                        1536, 49152)
    assert cfg.blocks == ("attn+mlp",) * 30 and cfg.tie_embeddings
    assert cfg.dtype == cfg.param_dtype == "bfloat16"
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    # the MoE configs build too (tests/test_torch_mla_moe_models.py holds
    # their reduced cuts to the reference); no weights are drawn here
    assert build_model(get_config("deepseek-v3-671b"), device="cpu").cfg \
        .mixer_kinds[0] == "mla"


def test_full_width_gemma_and_danube_are_the_published_shapes():
    g = get_config("gemma-2b")
    assert (g.num_layers, g.d_model, g.num_heads, g.num_kv_heads,
            g.head_dim, g.d_ff, g.vocab_size) == (18, 2048, 8, 1, 256, 16384,
                                                  256000)
    assert g.blocks == ("attn+mlp",) * 18 and g.mlp_kind == "geglu"
    assert g.scale_embed and g.tie_embeddings
    assert g.source == "arXiv:2403.08295"
    h = get_config("h2o-danube-1.8b")
    assert (h.num_layers, h.d_model, h.num_heads, h.num_kv_heads,
            h.head_dim, h.d_ff, h.vocab_size, h.window_size) == (
        24, 2560, 32, 8, 80, 6912, 32000, 4096)
    assert h.blocks == ("swa+mlp",) * 24 and h.mlp_kind == "swiglu"
    assert not h.tie_embeddings and h.source == "arXiv:2401.16818"
    s = get_config("smollm-360m")
    assert (s.num_layers, s.d_model, s.num_heads, s.num_kv_heads,
            s.head_dim, s.d_ff) == (32, 960, 15, 5, 64, 2560)
    # the reduced cuts are the reference's
    gr, hr = get_config("gemma-2b-reduced"), get_config("h2o-danube-1.8b-reduced")
    assert (gr.num_layers, gr.d_model, gr.num_heads, gr.num_kv_heads,
            gr.head_dim, gr.mlp_kind) == (2, 256, 4, 1, 64, "geglu")
    assert hr.blocks == ("swa+mlp",) * 2 and hr.window_size == 16
    for cfg in (g, h, s, gr, hr):
        assert build_model(cfg, device="cpu").cfg is cfg


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


def test_geglu_mlp_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_gate", (32, 48)), ("w_up", (32, 48)),
                      ("w_down", (48, 32)))}
    out = tmlp.mlp_fwd({k: t(v) for k, v in p.items()}, t(x), "geglu")
    ref = jmlp.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), "geglu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert set(tmlp.init_mlp(torch.Generator().manual_seed(0), 32, 48,
                             "geglu", torch.float32)) == set(p)
    with pytest.raises(ValueError):
        tmlp.mlp_fwd({k: t(v) for k, v in p.items()}, t(x), "relu")


# --------------------------------------------------------------------------
# the no-cache attention: blocked_attention and attention_fwd
# --------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
@pytest.mark.parametrize("s,blocks", [(12, (512, 1024)), (37, (8, 16)),
                                      (32, (16, 8))])
def test_blocked_attention_matches_reference(causal, window, s, blocks):
    """Causal, windowed and bidirectional; one block, and S not a
    multiple of the blocks (padded queries and keys)."""
    rng = np.random.default_rng(s + window)
    b, h, kv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    bq, bk = blocks
    ref = jattn.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=causal, window=window, scale=d ** -0.5,
        block_q=bq, block_k=bk)
    out = tattn.blocked_attention(
        t(q), t(k), t(v), torch.from_numpy(pos.copy()),
        torch.from_numpy(pos.copy()), causal=causal, window=window,
        scale=d ** -0.5, block_q=bq, block_k=bk)
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("s", [9, 21])
def test_attention_fwd_matches_reference(window, s):
    cfg, jcfg = configs(ARCH)
    rng = np.random.default_rng(7 + s)
    dm, h, kv, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": (dm, h * d), "wk": (dm, kv * d), "wv": (dm, kv * d),
         "wo": (h * d, dm)}
    p = {k: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
         for k, sh in p.items()}
    x = rng.standard_normal((2, s, dm)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    ref = jattn.attention_fwd({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jnp.asarray(pos), jcfg,
                              window=window)
    out = tattn.attention_fwd({k: t(v) for k, v in p.items()}, t(x),
                              torch.from_numpy(pos.copy()), cfg,
                              window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


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
def test_params_from_jax_takes_the_new_configs():
    """The block layouts are the reference's: GeGLU, ``swa`` and the
    untied head unstack as the others do."""
    for arch in DENSE[1:] + (GEMMA_D256,):
        cfg = configs(arch)[0]
        _, _, tree = reference_of(arch)
        params = params_from_jax(tree, cfg, device="cpu")
        stacked = tree["groups"][0]
        assert len(params["layers"]) == cfg.num_layers
        for i, layer in enumerate(params["layers"]):
            for name in ("wq", "wk", "wo"):
                np.testing.assert_array_equal(layer["attn"][name].numpy(),
                                              stacked["attn"][name][i])
            np.testing.assert_array_equal(layer["mlp"]["w_gate"].numpy(),
                                          stacked["mlp"]["w_gate"][i])
        assert ("head" in params) == (not cfg.tie_embeddings) \
            == ("head" in tree)
        fresh = build_model(cfg, device="cpu").init(torch.Generator())
        assert params["layers"][0]["attn"]["wk"].shape == \
            fresh["layers"][0]["attn"]["wk"].shape


# --------------------------------------------------------------------------
# prefill + decode against the reference
# --------------------------------------------------------------------------
PREFILL_CASES = [(2, 16, ARCH), (1, 9, ARCH)] + [
    (b, s, arch) for arch in ("gemma-2b-reduced", "h2o-danube-1.8b-reduced",
                              GEMMA_D256)
    for b, s in ((2, 16), (1, 9))]


@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize(
    "b,s,arch", PREFILL_CASES,
    ids=[f"{b}-{s}" if a == ARCH else f"{b}-{s}-{a}"
         for b, s, a in PREFILL_CASES])
def test_prefill_and_decode_match_reference(kernel_route, b, s, arch):
    jmodel, jparams, tree = reference_of(arch)
    cfg = routes(configs(arch)[0], kernel_route)
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
    assert tc["k"].shape == jkv["k"].shape
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


@pytest.mark.parametrize("kernel_route", [True, False])
def test_swa_ring_buffer_long_decode_matches_reference(kernel_route):
    """h2o-danube-1.8b-reduced (window 16): a 24-token prompt fills the
    16-slot ring buffer past its wrap, then 8 decode steps go round it
    again, each step's logits against the reference's (mirrors the
    reference's ``test_swa_ring_buffer_long_decode``)."""
    arch = "h2o-danube-1.8b-reduced"
    jmodel, jparams, tree = reference_of(arch)
    cfg = routes(configs(arch)[0], kernel_route)
    assert cfg.window_size == 16
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    b, s, steps = 2, 24, 8
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s + steps)).astype(np.int32)
    cache_len = s + steps + 2
    jl, jc = jmodel.prefill(jparams, {"tokens": toks[:, :s]},
                            cache_len=cache_len)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :s])},
                           cache_len=cache_len)
    assert tc["k"].shape[2] == jc["groups"][0]["kv"]["k"].shape[2] == 16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for i in range(s, s + steps):
        tok = toks[:, i:i + 1]
        jl, jc = jmodel.decode_step(jparams, jc, tok)
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(),
                                   np.asarray(jc["groups"][0]["kv"][n]),
                                   atol=ATOL)


# --------------------------------------------------------------------------
# the no-cache forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED + (GEMMA_D256,))
def test_forward_matches_reference(arch):
    jmodel, jparams, tree = reference_of(arch)
    cfg = configs(arch)[0]
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jl, jaux = jmodel.forward(jparams, {"tokens": toks})
    tl, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 21, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert float(aux) == float(jaux) == 0.0
    jh, _ = jmodel.forward_hidden(jparams, {"tokens": toks})
    th, _ = model.forward_hidden(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)


S_FWD = 12


@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_matches_forward(arch, kernel_route):
    """Prefill of S - 1 tokens gives forward's logits at S - 2, one
    decode step those at S - 1 (the reference's
    ``test_prefill_decode_matches_forward``, at its 2e-2)."""
    _, _, tree = reference_of(arch)
    cfg = routes(configs(arch)[0], kernel_route)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, S_FWD)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks})
    last, cache = model.prefill(params, {"tokens": toks[:, :S_FWD - 1]},
                                cache_len=S_FWD + 4)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(),
                               atol=2e-2, rtol=2e-2)
    dec, _ = model.decode_step(params, cache, toks[:, S_FWD - 1:])
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("arch", ["zamba2-2.7b-reduced", "rwkv6-1.6b-reduced",
                                  "h2o-danube-1.8b-reduced"])
def test_multi_step_decode_matches_forward(arch, kernel_route):
    """Four consecutive decode steps match the forward (the reference's
    ``test_multi_step_decode``, at its 3e-2), and a prompt past the
    window: prefill of 23 tokens then one step against forward over 24
    (its ``test_swa_ring_buffer_long_decode``)."""
    _, _, tree = reference_of(arch)
    cfg = routes(configs(arch)[0], kernel_route)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": toks[:, :S_FWD]})
    k = 4
    _, cache = model.prefill(params, {"tokens": toks[:, :S_FWD - k]},
                             cache_len=S_FWD + 4)
    for i in range(S_FWD - k, S_FWD):
        logits, cache = model.decode_step(params, cache, toks[:, i:i + 1])
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   atol=3e-2, rtol=3e-2)
    full, _ = model.forward(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, cache_len=26)
    dec, _ = model.decode_step(params, cache, toks[:, -1:])
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(),
                               atol=3e-2, rtol=3e-2)


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


def test_moe_blocks_on_the_dense_stack_are_admitted():
    """An ``attn+moe`` stack (the MoE family's blocks) builds once its
    experts are set, and runs; without experts it is refused."""
    cfg = get_config(ARCH)
    n = cfg.num_layers
    moe = dataclasses.replace(cfg, blocks=("attn+moe",) * n, num_experts=4,
                              num_experts_per_tok=2, moe_d_ff=32,
                              moe_capacity_factor=4.0)
    model = build_model(moe, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, moe.vocab_size, (2, 5)).astype(np.int32))
    logits, aux = model.forward(params, {"tokens": toks})
    assert logits.shape == (2, 5, moe.padded_vocab) and float(aux) > 0
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, blocks=("attn+moe",) * n),
                    device="cpu")


def test_unported_configs_are_refused():
    cfg = get_config(ARCH)
    n = cfg.num_layers
    for change in (dict(rope_kind="mrope"), dict(logit_softcap=30.0),
                   dict(mlp_kind="gelu"),
                   dict(blocks=("rwkv6+mlp",) * n, rope_kind="none"),
                   dict(blocks=("attn+mlp", "rwkv6+rwkv_cm")),
                   dict(blocks=("attn+mlp", "swa+mlp"), window_size=8),
                   dict(blocks=("swa+mlp",) * n, window_size=8,
                        mlp_kind="gelu"),
                   dict(blocks=("rwkv6+rwkv_cm",) * n),   # with RoPE
                   dict(blocks=("rwkv6+rwkv_cm",) * n, rope_kind="none",
                        logit_softcap=30.0)):
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(cfg, **change), device="cpu")
