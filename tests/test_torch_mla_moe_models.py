"""The MoE family against the JAX package, on the CPU: kimi-k2 (GQA
``attn+mlp`` then ``attn+moe`` groups) and deepseek-v3 (MLA, ``mla+mlp``
then ``mla+moe``, an MTP head of depth 1), at their reduced cuts.

The reference runs the reduced configs in f32 with its Pallas kernel
routes on (interpret mode; deepseek's MLA never reaches a kernel) on
its ``key(0)`` weights; the port loads the same weights through
``params_from_jax`` and runs its plain PyTorch routes (and, for the
route flags, the same plain kernel versions).  Inputs are drawn with
numpy from a seed.  The reduced configs carry the reference's no-drop
capacity factor (4.0), so prefill + decode equals the forward.
Tolerances: the logits within 1e-4 absolute (the experts' outputs sum
before the head: the reference's own MoE tolerance,
``tests/test_moe.py``), the auxiliary loss within 1e-6, the caches
within 1e-5; prefill + decode against the no-cache forward at 1e-4; the
token backend's greedy ids equal the reference's ``TokenJaxBackend``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import transformer as jtfm
from repro.serving import scenarios as jax_scenarios
from repro.serving import token_backend as jax_tb
from repro_torch.configs import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.serving import scenarios
from repro_torch.serving import token_backend as tb

KIMI, DEEPSEEK = "kimi-k2-1t-a32b-reduced", "deepseek-v3-671b-reduced"
ARCHS = (KIMI, DEEPSEEK)
ATOL = 1e-4


def routes(cfg, on: bool):
    return dataclasses.replace(cfg, use_pallas_prefill=on,
                               use_pallas_decode=on)


_REFS = {}


def reference_of(arch, on=True):
    """The reference model of ``arch`` (kernel routes ``on``), its key(0)
    params and the same params as numpy arrays."""
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
    return build_model(cfg, device="cpu"), params_from_jax(tree, cfg, "cpu")


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _shapes(tr, lead=0):
    return {k: _shapes(v, lead) if isinstance(v, dict)
            else tuple(v.shape[lead:]) for k, v in tr.items()}


# --------------------------------------------------------------------------
# configs, groups, parameters, caches
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ("kimi-k2-1t-a32b",
                                          "deepseek-v3-671b"))
def test_config_maps_field_for_field(arch):
    ref, port = jax_config(arch), get_config(arch)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.uses_moe and port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert ttfm.layer_groups(port) == jtfm.layer_groups(ref)


def test_published_widths_and_the_two_layer_cut():
    """The full configs build (no weights drawn here); their cut to one
    dense and one MoE layer keeps every width."""
    k, d = get_config("kimi-k2-1t-a32b"), get_config("deepseek-v3-671b")
    assert (k.d_model, k.num_heads, k.num_kv_heads, k.head_dim,
            k.num_experts, k.num_experts_per_tok, k.moe_d_ff) == (
        7168, 64, 8, 128, 384, 8, 2048)
    assert (d.q_lora_rank, d.kv_lora_rank, d.qk_nope_dim, d.qk_rope_dim,
            d.v_head_dim, d.num_experts, d.mtp_depth) == (
        1536, 512, 128, 64, 128, 256, 1)
    for cfg in (k, d):
        assert build_model(cfg, device="cpu").cfg is cfg
        cut = dataclasses.replace(cfg, num_layers=2,
                                  blocks=cfg.blocks[:1] + cfg.blocks[-1:],
                                  first_k_dense=1)
        assert build_model(cut, device="cpu").cfg.blocks == cut.blocks
        assert len(ttfm.layer_groups(cut)) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_unstacks_both_groups(arch):
    cfg = get_config(arch)
    _, _, tree = reference_of(arch)
    params = params_from_jax(tree, cfg, device="cpu")
    fresh = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert set(params) == set(fresh)
    assert len(tree["groups"]) == 2
    assert len(params["layers"]) == cfg.num_layers == 2
    for i, (group, layer, new) in enumerate(zip(tree["groups"],
                                                params["layers"],
                                                fresh["layers"])):
        assert _shapes(layer) == _shapes(new) == _shapes(group, 1)
        mixer = cfg.blocks[i].split("+")[0]
        name = "wq" if mixer == "attn" else "w_dkv"
        np.testing.assert_array_equal(layer[mixer][name].numpy(),
                                      group[mixer][name][0])
    moe = params["layers"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    if cfg.mtp_depth:
        assert _shapes(params["mtp"]) == _shapes(fresh["mtp"]) == \
            _shapes(tree["mtp"])
    else:
        assert "mtp" not in params
    with pytest.raises(ValueError):
        params_from_jax(dict(tree, groups=tree["groups"][:1]), cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_reference_groups(arch):
    """The port's cache is the reference's groups with their layer axes
    concatenated."""
    cfg = get_config(arch)
    jmodel, _, _ = reference_of(arch)
    jcache = jmodel.init_cache(2, 12)
    cache = build_model(cfg, device="cpu").init_cache(2, 12)
    names = ("c_kv", "k_rope") if "mla" in cfg.mixer_kinds else ("k", "v")
    for n in names:
        ref = np.concatenate([np.asarray(g["kv"][n])
                              for g in jcache["groups"]])
        assert tuple(cache[n].shape) == ref.shape
    assert set(cache) == set(names) | {"index"}


def test_expert_share_params_and_a_share_model():
    """``init(experts=...)``: every MoE layer (the MTP block's too) holds
    its share and routes over all experts; the share model's prefill +
    decode equals its forward."""
    cfg = get_config(DEEPSEEK)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), experts=(1, 2))
    for moe in (params["layers"][1]["moe"], params["mtp"]["block"]["moe"]):
        assert moe["wg"].shape[0] == 2 and int(moe["expert_lo"]) == 1
        assert moe["router"].shape == (cfg.d_model, cfg.num_experts)
        assert "shared" not in moe
    toks = torch.from_numpy(tokens(cfg, 2, 9, 3))
    full, aux = model.forward(params, {"tokens": toks})
    assert float(aux) > 0
    last, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                cache_len=12)
    np.testing.assert_allclose(last.numpy(), full[:, -2].numpy(), atol=ATOL)
    dec, _ = model.decode_step(params, cache, toks[:, -1:])
    np.testing.assert_allclose(dec.numpy(), full[:, -1].numpy(), atol=ATOL)


# --------------------------------------------------------------------------
# forward, aux, MTP, prefill and decode against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_hidden_match_reference(arch):
    jmodel, jparams, _ = reference_of(arch)
    model, params = port_of(arch)
    toks = tokens(model.cfg, 2, 13, 8)
    jl, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    tl, aux = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 13, model.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    jh, _ = jmodel.forward_hidden(jparams, {"tokens": jnp.asarray(toks)})
    th, _ = model.forward_hidden(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)


def test_mtp_logits_match_reference():
    """DeepSeek-V3's MTP head (depth 1) on the reference's hidden states:
    logits of shape (B, S - 1, V) and the head block's aux loss."""
    jmodel, jparams, _ = reference_of(DEEPSEEK)
    model, params = port_of(DEEPSEEK)
    toks = tokens(model.cfg, 2, 11, 12)
    jh, _ = jmodel.forward_hidden(jparams, {"tokens": jnp.asarray(toks)})
    jl, jaux = jmodel.mtp_logits(jparams, jh, jnp.asarray(toks))
    tl, aux = model.mtp_logits(params, torch.from_numpy(np.array(jh)),
                               torch.from_numpy(toks))
    assert tl.shape == (2, 10, model.cfg.padded_vocab) == np.asarray(jl).shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    th, _ = model.forward_hidden(params, {"tokens": torch.from_numpy(toks)})
    tl2, _ = model.mtp_logits(params, th, torch.from_numpy(toks))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl), atol=ATOL)


def test_mtp_on_a_dense_stack_matches_reference():
    """MTP is admitted on the dense stacks too, as in the reference: its
    block is the stack's last kind (``attn+mlp``), whose aux is 0."""
    jcfg = dataclasses.replace(jax_config("smollm-135m-reduced"),
                               mtp_depth=1)
    cfg = dataclasses.replace(get_config("smollm-135m-reduced"), mtp_depth=1)
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = tokens(cfg, 2, 9, 21)
    jh, _ = jmodel.forward_hidden(jparams, {"tokens": jnp.asarray(toks)})
    jl, jaux = jmodel.mtp_logits(jparams, jh, jnp.asarray(toks))
    th, _ = model.forward_hidden(params, {"tokens": torch.from_numpy(toks)})
    tl, aux = model.mtp_logits(params, th, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, kernel_route):
    """Prefill then four greedy decode steps, each route against the
    same route of the reference: logits, caches and index."""
    jmodel, jparams, _ = reference_of(arch, kernel_route)
    model, params = port_of(arch, kernel_route)
    cfg = model.cfg
    b, s = 2, 10
    toks = tokens(cfg, b, s, 16)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            cache_len=s + 5)
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache_len=s + 5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    names = ("c_kv", "k_rope") if "mla" in cfg.mixer_kinds else ("k", "v")

    def check_cache():
        for n in names:
            ref = np.concatenate([np.asarray(g["kv"][n])
                                  for g in jc["groups"]])
            np.testing.assert_allclose(tc[n].numpy(), ref, atol=1e-5)

    check_cache()
    tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
    for step in range(4):
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok[:, None]))
        tl, tc = model.decode_step(params, tc, torch.from_numpy(tok)[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        assert int(tc["index"]) == int(jc["index"]) == s + step + 1
        tok = np.argmax(np.asarray(jl)[:, :cfg.vocab_size], -1).astype(np.int32)
        assert np.array_equal(tl[:, :cfg.vocab_size].argmax(-1).numpy(), tok)
    check_cache()


@pytest.mark.parametrize("kernel_route", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, kernel_route):
    """At the no-drop capacity factor of the reduced cut: prefill of
    S - 3 tokens, then three decode steps teacher-forced with the rest,
    give the no-cache forward's logits at every position."""
    model, params = port_of(arch, kernel_route)
    cfg = model.cfg
    assert cfg.moe_capacity_factor == float(cfg.num_experts)
    toks = torch.from_numpy(tokens(cfg, 2, 12, 9))
    full, _ = model.forward(params, {"tokens": toks})
    last, cache = model.prefill(params, {"tokens": toks[:, :9]},
                                cache_len=16)
    np.testing.assert_allclose(last.numpy(), full[:, 8].numpy(), atol=ATOL)
    for i in range(9, 12):
        dec, cache = model.decode_step(params, cache, toks[:, i:i + 1])
        np.testing.assert_allclose(dec.numpy(), full[:, i].numpy(),
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_a_given_cache_matches_a_fresh_one(arch):
    model, params = port_of(arch)
    toks = [torch.from_numpy(tokens(model.cfg, 2, 6, s)) for s in (18, 19)]
    static = model.init_cache(2, 10)
    model.prefill(params, {"tokens": toks[0]}, cache=static)
    model.decode_step(params, static, toks[0][:, :1])
    l_static, _ = model.prefill(params, {"tokens": toks[1]}, cache=static)
    l_fresh, fresh = model.prefill(params, {"tokens": toks[1]}, cache_len=10)
    assert torch.equal(l_static, l_fresh)
    a, _ = model.decode_step(params, static, toks[1][:, :1])
    b, _ = model.decode_step(params, fresh, toks[1][:, :1])
    assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the token backend: greedy ids equal the reference's TokenJaxBackend's
# --------------------------------------------------------------------------
SLICE = dict(requests=6, seed=3, prompt_len=8, max_decode=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_backend_ids_equal_reference(arch):
    n, seed = SLICE["requests"], SLICE["seed"]
    pl, md = SLICE["prompt_len"], SLICE["max_decode"]
    jbatch, jmeta = jax_scenarios.build_scenario("llm-chat", requests=n,
                                                 seed=seed)
    jrunner, jbackend, jcfg, _ = jax_tb.make_token_live_server(
        arch, prompt_len=pl, max_decode=md, clock="modeled",
        prior_rps=jmeta["expected_rps"], tick=jmeta["tick"],
        cost=jmeta["cost"])
    rng = np.random.default_rng(seed)
    jarr = []
    for r in jbatch.head(n).to_requests():
        r = type(r).make(arrival=r.arrival, comm_latency=r.comm_latency,
                         slo=r.slo, size_kb=r.size_kb,
                         prompt_tokens=min(r.prompt_tokens, pl),
                         decode_tokens=min(r.decode_tokens, md),
                         tbt_slo=r.tbt_slo)
        jarr.append((r, rng.integers(0, jcfg.vocab_size, r.prompt_tokens)
                     .astype(np.int32)))
    jrep = jrunner.run(jarr)
    tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
    params = params_from_jax(tree, get_config(arch), device="cpu")
    batch, meta = scenarios.build_scenario("llm-chat", requests=n, seed=seed)
    runner, backend, cfg, _ = tb.make_token_live_server(
        arch, prompt_len=pl, max_decode=md, clock="modeled",
        prior_rps=meta["expected_rps"], tick=meta["tick"], cost=meta["cost"],
        params=params, device="cpu")
    arr = tb.scenario_arrivals(batch, n, seed, pl, md, cfg.vocab_size)
    rep = runner.run(arr)
    ids = [backend.generated.get(r.id) for r, _ in arr]
    jids = [jbackend.generated.get(r.id) for r, _ in jarr]
    assert ids == jids and rep.tokens_served == jrep.tokens_served > 0
    assert rep.buckets == jrep.buckets


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_moe_family_on_cpu(arch):
    out = launcher.main(["--scenario", "llm-chat", "--device", "cpu",
                         "--arch", arch, "--requests", "4",
                         "--prompt-len", "8", "--gen-tokens", "2",
                         "--seed", "2"])
    assert out["engine"] == "token-torch" and out["n"] > 0
    assert out["tokens_served"] > 0
