"""The port's Qwen2-VL and whisper stacks against the JAX package's, on
the CPU.

The reference runs the reduced cuts (``qwen2-vl-2b-reduced``: M-RoPE
sections 8/12/12 over head_dim 64, 8 patch embeddings before the
prompt; ``whisper-large-v3-reduced``: 2 encoder and 2 decoder layers, 32
encoder frames, learned positions, GELU) in f32 with its Pallas kernel
routes on (interpret mode) or off; the port loads the same weights
through ``params_from_jax`` and runs the same route: its kernel route
on the CPU is each kernel's plain version, its plain route the
reference's plain code.  Inputs are drawn with numpy from a seed.

M-RoPE ids come in two kinds.  ``rising``: t = 0..S-1 over the whole
sequence, h and w the row and column of a grid over the patches and
then the sequence index for the text; the ids differ between sections,
and the temporal ids rise in sequence order, so the reference's two
prefill routes agree.  ``grid``: one image as the reference's data
pipeline lays it out (t = 0 for every patch); there the reference's
Pallas route (causal in sequence order) and its plain route (masked by
the temporal ids: the patches see each other both ways) differ, and
each route of the port is held to the same route of the reference.

Tolerances: 2e-5 for the building blocks (the kernels' f32 tolerance),
1e-4 for forward, prefill and decode (``tests/test_torch_models.py``),
2e-2 for prefill + decode against forward (the reference's own
``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm

ATOL = 1e-4
QWEN, WHISPER = "qwen2-vl-2b-reduced", "whisper-large-v3-reduced"
ARCHS = (QWEN, WHISPER)


def routes(cfg, on: bool):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


_REFS = {}


def reference_of(arch, on=True):
    """The reference model of ``arch`` with both kernel routes ``on``,
    its key(0) params and the same params as numpy arrays."""
    if (arch, on) not in _REFS:
        model = jax_build(routes(jax_config(arch), on))
        params = model.init(jax.random.key(0))
        _REFS[arch, on] = (model, params, jax.tree.map(np.asarray, params))
    return _REFS[arch, on]


def port_of(arch, on=True):
    """The port's model of ``arch`` on the CPU with the reference's
    weights."""
    cfg = routes(get_config(arch), on)
    _, _, tree = reference_of(arch, on)
    return build_model(cfg, device="cpu"), params_from_jax(tree, cfg,
                                                           device="cpu")


def mrope_ids(p, s, b, kind):
    """(3, B, P + S) M-RoPE ids: ``rising`` or ``grid`` (module doc)."""
    side = max(int(np.sqrt(p)), 1)
    pos = np.broadcast_to(np.arange(p + s, dtype=np.int32),
                          (3, b, p + s)).copy()
    pos[1, :, :p] = np.arange(p) // side
    pos[2, :, :p] = np.arange(p) % side
    if kind == "grid":
        pos[0, :, :p] = 0
    return pos


def make_batch(cfg, b, s, seed, ids="rising"):
    """numpy inputs of one batch: tokens, and the prefix or the encoder
    frames of the stack."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    p = cfg.num_patch_tokens
    if p:
        batch["prefix_embeds"] = (0.5 * rng.standard_normal(
            (b, p, cfg.d_model))).astype(np.float32)
        batch["mrope_positions"] = mrope_ids(p, s, b, ids)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = (0.5 * rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", QWEN, "whisper-large-v3",
                                  WHISPER])
def test_config_maps_field_for_field(arch):
    ref, port = jax_config(arch), get_config(arch)
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for n in names:
        assert getattr(port, n) == getattr(ref, n), n
    assert port.padded_vocab == ref.padded_vocab
    assert port.param_count() == ref.param_count() > 0
    assert build_model(port, device="cpu").cfg is port


def test_full_width_configs_are_the_published_shapes():
    q = get_config("qwen2-vl-2b")
    assert (q.num_layers, q.d_model, q.num_heads, q.num_kv_heads,
            q.head_dim, q.d_ff, q.vocab_size, q.num_patch_tokens) == (
        28, 1536, 12, 2, 128, 8960, 151936, 256)
    assert (q.rope_kind, q.mrope_sections, q.mlp_kind) == (
        "mrope", (16, 24, 24), "swiglu")
    assert q.source == "arXiv:2409.12191"
    w = get_config("whisper-large-v3")
    assert (w.num_layers, w.encoder_layers, w.d_model, w.num_heads,
            w.num_kv_heads, w.head_dim, w.d_ff, w.vocab_size,
            w.encoder_seq_len) == (32, 32, 1280, 20, 20, 64, 5120, 51866, 1500)
    assert (w.rope_kind, w.mlp_kind, w.is_encoder_decoder) == (
        "learned", "gelu", True)
    assert w.padded_vocab == 51968 and w.source == "arXiv:2212.04356"
    # the reduced M-RoPE sections follow the reference's rule
    assert get_config(QWEN).mrope_sections == (8, 12, 12)


REFUSED = [(QWEN, c) for c in (dict(logit_softcap=30.0),
                                dict(num_patch_tokens=0),
                                dict(mlp_kind="gelu"), dict(mtp_depth=1),
                                dict(is_encoder_decoder=True,
                                     encoder_layers=2, encoder_seq_len=8),
                                dict(rope_kind="learned"))] + [
    (WHISPER, c) for c in (dict(logit_softcap=30.0),
                           dict(num_patch_tokens=8),
                           dict(mlp_kind="swiglu"), dict(mtp_depth=1),
                           dict(rope_kind="standard"),
                           dict(encoder_layers=0))]


@pytest.mark.parametrize("arch,change", REFUSED,
                         ids=[f"{a}-{next(iter(c))}" for a, c in REFUSED])
def test_only_the_two_configs_are_admitted(arch, change):
    """Qwen2-VL and whisper as configured; a softcap, an MTP head or a
    mix of their features is refused."""
    build_model(get_config(arch), device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(get_config(arch), **change),
                    device="cpu")


# --------------------------------------------------------------------------
# numerics of the building blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ids", ["rising", "grid"])
@pytest.mark.parametrize("d,sections", [(64, (8, 12, 12)),
                                        (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(d, sections, ids):
    """Distinct t/h/w ids (not arange in all three, which is standard
    RoPE), at the reduced and the full head_dim."""
    rng = np.random.default_rng(d)
    b, p, s = 2, 16, 5
    x = rng.standard_normal((b, p + s, 3, d)).astype(np.float32)
    pos = mrope_ids(p, s, b, ids)
    assert not (np.array_equal(pos[0], pos[1])
                and np.array_equal(pos[1], pos[2]))
    out = tcommon.apply_mrope(t(x), torch.from_numpy(pos), 1e6, sections)
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    # the sections matter: standard RoPE over the temporal ids differs
    std = tcommon.apply_rope(t(x), torch.from_numpy(pos[0]), 1e6)
    assert float((std - out).abs().max()) > 1e-2
    bf = tcommon.apply_mrope(t(x).bfloat16(), torch.from_numpy(pos), 1e6,
                             sections)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("cap", [0.0, 5.0])
def test_layer_norm_and_softcap_match_reference(cap):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32) * 3
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.layer_norm(t(x), t(scale), t(bias), 1e-5).numpy(),
        np.asarray(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                      jnp.asarray(bias), 1e-5)), atol=2e-5)
    np.testing.assert_allclose(
        tcommon.softcap(t(x), cap).numpy(),
        np.asarray(jcommon.softcap(jnp.asarray(x), cap)), atol=2e-5)


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_up", (32, 48)), ("w_down", (48, 32)))}
    out = tmlp.mlp_fwd({k: t(v) for k, v in p.items()}, t(x), "gelu")
    ref = jmlp.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), "gelu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert set(tmlp.init_mlp(torch.Generator().manual_seed(0), 32, 48,
                             "gelu", torch.float32)) == set(p)


@pytest.mark.parametrize("cap", [0.0, 2.0])
def test_blocked_attention_softcap_matches_reference(cap):
    rng = np.random.default_rng(13)
    b, s, h, kv, d = 2, 37, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32) * 2
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32) * 2
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(causal=True, window=0, scale=d ** -0.5, cap=cap, block_q=8,
              block_k=16)
    ref = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos),
                                  jnp.asarray(pos), **kw)
    out = tattn.blocked_attention(t(q), t(k), t(v), torch.from_numpy(pos.copy()),
                                  torch.from_numpy(pos.copy()), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_attention_decode_softcap_matches_reference():
    """The dense decode route soft-caps its scores as the reference's
    (no config sets a cap; the kernel route is not taken with one)."""
    cfg = dataclasses.replace(get_config(QWEN), logit_softcap=3.0)
    jcfg = dataclasses.replace(jax_config(QWEN), logit_softcap=3.0)
    rng = np.random.default_rng(16)
    p = _attn_params(rng, cfg)
    b, s_cache, index = 2, 12, 7
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32) * 4
    shape = (b, s_cache, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    pos = np.stack([np.full((b, 1), i, np.int32) for i in (index, 2, 5)])
    ref, _ = jattn.attention_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.int32(index),
        jnp.asarray(pos), jcfg)
    out, _ = tattn.attention_decode(
        {k: t(v) for k, v in p.items()}, t(x), {"k": t(ck), "v": t(cv)},
        index, torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _attn_params(rng, cfg):
    dm, h, kv, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (dm, h * d), "wk": (dm, kv * d), "wv": (dm, kv * d),
              "wo": (h * d, dm)}
    return {k: (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)
            for k, sh in shapes.items()}


@pytest.mark.parametrize("kv_positions", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_fwd_matches_reference(arch, kv_positions):
    """``attention_fwd`` with ``kv_x``: keys from another sequence, no
    RoPE, not causal; default key positions 0..Sk-1 or given ones."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    rng = np.random.default_rng(14)
    p = _attn_params(rng, cfg)
    b, s, sk = 2, 9, 21
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((b, sk, cfg.d_model)).astype(np.float32)
    if cfg.rope_kind == "mrope":
        pos = mrope_ids(4, s - 4, b, "grid")
    else:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kp = (rng.integers(0, 50, (b, sk)).astype(np.int32) if kv_positions
          else None)
    ref = jattn.attention_fwd(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos), jcfg, causal=False, kv_x=jnp.asarray(enc),
        kv_positions=None if kp is None else jnp.asarray(kp))
    out = tattn.attention_fwd(
        {k: t(v) for k, v in p.items()}, t(x), torch.from_numpy(pos), cfg,
        causal=False, kv_x=t(enc),
        kv_positions=None if kp is None else torch.from_numpy(kp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("kernel_route", [True, False])
def test_cross_decode_matches_reference(kernel_route):
    """``_cross_decode`` over the encoder K/V: the kernel route
    (``decode_attention`` with lengths = S_enc, its plain version on the
    CPU) and the dense softmax, each against the reference's dense
    softmax."""
    cfg = routes(get_config(WHISPER), kernel_route)
    jcfg = jax_config(WHISPER)
    rng = np.random.default_rng(15)
    b, se = 3, cfg.encoder_seq_len
    p = {"norm_cross": rng.standard_normal(cfg.d_model).astype(np.float32)
         * 0.1, "cross": _attn_params(rng, cfg)}
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    shape = (b, se, cfg.num_kv_heads, cfg.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    ref = jtfm._cross_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                             {}, jcfg)
    tp = {"norm_cross": t(p["norm_cross"]),
          "cross": {k: t(v) for k, v in p["cross"].items()}}
    out = ttfm._cross_decode(tp, t(x), {"k": t(ck), "v": t(cv)}, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def _shapes(tr, lead=0):
    return {k: _shapes(v, lead) if isinstance(v, dict)
            else tuple(v.shape[lead:]) for k, v in tr.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_matches_init_params_layout(arch):
    """The encoder's stacked group unstacks into its own layer list (not
    a second decoder group), beside the learned position tables; every
    leaf has the shape ``init_params`` gives it."""
    cfg = get_config(arch)
    _, _, tree = reference_of(arch)
    params = params_from_jax(tree, cfg, device="cpu")
    fresh = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert set(params) == set(fresh)
    assert len(params["layers"]) == cfg.num_layers
    for layer, new in zip(params["layers"], fresh["layers"]):
        assert _shapes(layer) == _shapes(new) == _shapes(tree["groups"][0], 1)
    if cfg.is_encoder_decoder:
        assert set(params) >= {"pos_emb", "encoder"}
        stacked = tree["encoder"]["groups"][0]
        enc, fenc = params["encoder"], fresh["encoder"]
        assert len(enc["layers"]) == len(fenc["layers"]) == cfg.encoder_layers
        for i, layer in enumerate(enc["layers"]):
            assert _shapes(layer) == _shapes(fenc["layers"][i]) \
                == _shapes(stacked, 1)
            assert "cross" not in layer
            np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                          stacked["attn"]["wq"][i])
            np.testing.assert_array_equal(layer["mlp"]["w_up"].numpy(),
                                          stacked["mlp"]["w_up"][i])
        for name in ("pos_emb", "final_norm"):
            assert enc[name].shape == fenc[name].shape
            np.testing.assert_array_equal(enc[name].numpy(),
                                          tree["encoder"][name])
        assert params["pos_emb"].shape == fresh["pos_emb"].shape == (
            32768, cfg.d_model)
        np.testing.assert_array_equal(
            params["layers"][1]["cross"]["wk"].numpy(),
            tree["groups"][0]["cross"]["wk"][1])
    else:
        assert "pos_emb" not in params and "encoder" not in params


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_holds_the_cross_kv(arch):
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(2, 12)
    assert cache["k"].shape == (cfg.num_layers, 2, 12, cfg.num_kv_heads,
                                cfg.head_dim)
    if cfg.is_encoder_decoder:
        assert cache["cross"]["k"].shape == (
            cfg.num_layers, 2, cfg.encoder_seq_len, cfg.num_kv_heads,
            cfg.head_dim)
    else:
        assert "cross" not in cache


# --------------------------------------------------------------------------
# forward, prefill and decode against the reference
# --------------------------------------------------------------------------
CASES = [(QWEN, "rising"), (QWEN, "grid"), (WHISPER, "rising")]


@pytest.mark.parametrize("arch,ids", CASES)
def test_forward_matches_reference(arch, ids):
    jmodel, jparams, _ = reference_of(arch)
    model, params = port_of(arch)
    batch = make_batch(model.cfg, 2, 13, 8, ids)
    jl, jaux = jmodel.forward(jparams, batch)
    tl, aux = model.forward(params, torch_batch(batch))
    assert tl.shape == (2, 13 + model.cfg.num_patch_tokens,
                        model.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert float(aux) == float(jaux) == 0.0
    jh, _ = jmodel.forward_hidden(jparams, batch)
    th, _ = model.forward_hidden(params, torch_batch(batch))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)


@pytest.mark.parametrize("given", [True, False])
@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("arch,ids", CASES)
def test_prefill_and_decode_match_reference(arch, ids, kernel_route, given):
    """Prefill then three greedy decode steps, each route against the
    same route of the reference; M-RoPE decode ids given (the next
    position after the sequence's last) or None (the cache index)."""
    jmodel, jparams, _ = reference_of(arch, kernel_route)
    model, params = port_of(arch, kernel_route)
    cfg = model.cfg
    b, s = 2, 11
    batch = make_batch(cfg, b, s, 16, ids)
    p = cfg.num_patch_tokens
    cache_len = p + s + 4
    jl, jc = jmodel.prefill(jparams, batch, cache_len=cache_len)
    tl, tc = model.prefill(params, torch_batch(batch), cache_len=cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jgroup = jc["groups"][0]
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jgroup["kv"]["k"]),
                               atol=ATOL)
    if cfg.is_encoder_decoder:
        for n in ("k", "v"):
            np.testing.assert_allclose(tc["cross"][n].numpy(),
                                       np.asarray(jgroup["cross"][n]),
                                       atol=ATOL)
    assert int(tc["index"]) == int(jc["index"]) == p + s
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
    nxt = int(batch["mrope_positions"].max()) + 1 if p else 0
    for step in range(3):
        mp = (np.full((3, b, 1), nxt + step, np.int32)
              if p and given else None)
        jl, jc = jmodel.decode_step(jparams, jc, tok[:, None], mp)
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None],
                                   None if mp is None else torch.from_numpy(mp))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert int(tc["index"]) == int(jc["index"]) == p + s + step + 1
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
        assert np.array_equal(tl[:, :cfg.vocab_size].argmax(-1).numpy(), tok)
    np.testing.assert_allclose(tc["v"].numpy(),
                               np.asarray(jc["groups"][0]["kv"]["v"]),
                               atol=ATOL)


def test_reference_prefill_routes_disagree_on_a_single_image_grid():
    """A property of the reference, not of the port: with t = 0 for every
    patch its plain route lets the patches attend to each other both
    ways, its Pallas route does not; the port's two routes differ in the
    same way, each within tolerance of the reference's."""
    outs = {}
    for on in (True, False):
        jmodel, jparams, _ = reference_of(QWEN, on)
        model, params = port_of(QWEN, on)
        batch = make_batch(model.cfg, 2, 7, 17, "grid")
        jl, _ = jmodel.prefill(jparams, batch)
        tl, _ = model.prefill(params, torch_batch(batch))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        outs[on] = tl
    assert float((outs[True] - outs[False]).abs().max()) > 1e-2


S_FWD = 12


# the forward masks by the temporal ids: on a single-image grid only the
# plain route, which masks by them too, gives the forward's logits
FWD_CASES = [(a, i, on) for a, i in CASES for on in (True, False)
             if not (i == "grid" and on)]


@pytest.mark.parametrize("arch,ids,kernel_route", FWD_CASES)
def test_prefill_decode_matches_forward(arch, ids, kernel_route):
    """Prefill of S - 1 tokens gives forward's logits at S - 2, one
    decode step (ids of the last position given) those at S - 1 (the
    reference's ``test_prefill_decode_matches_forward``, at its 2e-2)."""
    model, params = port_of(arch, kernel_route)
    cfg = model.cfg
    p = cfg.num_patch_tokens
    batch = torch_batch(make_batch(cfg, 2, S_FWD, 9, ids))
    full, _ = model.forward(params, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :S_FWD - 1])
    if p:
        pre["mrope_positions"] = batch["mrope_positions"][:, :, :p + S_FWD - 1]
    last, cache = model.prefill(params, pre, cache_len=p + S_FWD + 4)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(),
                               atol=2e-2, rtol=2e-2)
    mp = batch["mrope_positions"][:, :, -1:] if p else None
    dec, _ = model.decode_step(params, cache, batch["tokens"][:, -1:], mp)
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_a_given_cache_matches_a_fresh_one(arch):
    """A captured step's static cache: prefill zeroes it (the cross K/V
    too) and fills it as a fresh one, so the steps after it agree."""
    model, params = port_of(arch)
    cfg = model.cfg
    p = cfg.num_patch_tokens
    first = torch_batch(make_batch(cfg, 2, 6, 18))
    second = torch_batch(make_batch(cfg, 2, 6, 19))
    static = model.init_cache(2, p + 10)
    model.prefill(params, first, cache=static)
    model.decode_step(params, static, first["tokens"][:, :1])
    l_static, _ = model.prefill(params, second, cache=static)
    l_fresh, fresh = model.prefill(params, second, cache_len=p + 10)
    np.testing.assert_array_equal(l_static.numpy(), l_fresh.numpy())
    tok = second["tokens"][:, :1]
    a, _ = model.decode_step(params, static, tok)
    b_, _ = model.decode_step(params, fresh, tok)
    np.testing.assert_array_equal(a.numpy(), b_.numpy())
