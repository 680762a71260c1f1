"""Published Zamba2 (zamba2-7b) on the CPU: the configuration, and the
port at a tiny size (two groups of B and C, two shared blocks with two
applications each, adapters and norms drawn away from their init)
against the plain reference (``repro_torch.plain.zamba2``), which is
held against ``transformers``' ``Zamba2ForCausalLM`` where that package
is importable.  The kernels' new cases (grouped ``ssd_scan``, head_dim
224 with a softmax scale, the erf GeGLU) are held against their plain
versions on the card in ``tests/test_torch_cuda.py``."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCH_IDS, get_config, list_archs
from repro_torch.configs.registry import MODEL_ACCURACY
from repro_torch.kernels.decode_attention.ops import decode_attention_plain
from repro_torch.kernels.glu_gate.ops import glu_gate_plain
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.swa_prefill.ops import swa_prefill_plain
from repro_torch.models import build_model
from repro_torch.plain import zamba2 as plain

S, STEPS = 20, 6


def tiny_config():
    """Zamba2-7B's form at d 64: 6 layers, 4 of them hybrid (blocks 0, 1,
    0, 1), 8 SSD heads of 16 in 2 groups, 4 heads of 32 (2 d = H D)."""
    return dataclasses.replace(
        get_config("zamba2-7b"), name="zamba2-7b-tiny", num_layers=6,
        blocks=("mamba2+none",) * 6, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=96, vocab_size=128,
        ssm_state_dim=16, ssm_head_dim=16, hybrid_layer_ids=(1, 2, 4, 5),
        adapter_rank=8, dtype="float32", param_dtype="float32", remat=False)


def tiny_params(cfg, seed=0):
    """The port's init, with every vector leaf (norms, conv biases, dt
    bias, A, D) moved away from its init by N(0, 0.1^2)."""
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(seed))
    gen = torch.Generator().manual_seed(seed + 1)

    def walk(node):
        for v in (node.values() if isinstance(node, dict) else node):
            if isinstance(v, (dict, list)):
                walk(v)
            elif v.dim() == 1:
                v.add_(0.1 * torch.randn(v.shape, generator=gen))

    walk(params)
    return model, params


@pytest.fixture(scope="module")
def setting():
    plain.strict_f32()
    cfg = tiny_config()
    model, params = tiny_params(cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, S + STEPS),
                        generator=torch.Generator().manual_seed(3))
    ref = torch.stack([plain.logits(params, tok[b], torch.arange(S + STEPS),
                                    dataclasses.asdict(cfg))
                       for b in range(2)])
    return cfg, model, params, tok, ref


def _close(got, ref, rel):
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= rel * scale


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------
def test_the_published_configuration():
    cfg = get_config("zamba2-7b")
    assert cfg.param_count() == 7_356_749_648
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_num_heads,
            cfg.ssm_groups, cfg.head_dim, cfg.d_ff) == (
        81, 3584, 7168, 112, 2, 224, 14336)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert cfg.softmax_scale == pytest.approx(112 ** -0.5)
    assert cfg.num_heads * cfg.head_dim == 2 * cfg.d_model
    assert build_model(cfg, device="cpu").cfg is cfg
    # the reference's set stays as it is
    for names in (ARCH_IDS, list_archs(), MODEL_ACCURACY):
        assert "zamba2-7b" not in names
    old = get_config("zamba2-2.7b")
    assert not old.published_hybrid and old.ssm_groups == 1
    assert old.softmax_scale is None


def test_param_count_matches_transformers():
    transformers = pytest.importorskip("transformers")
    cfg = tiny_config()
    hf = transformers.Zamba2ForCausalLM(_hf_config(transformers, cfg))
    seen = {id(p): p.numel() for p in hf.parameters()}
    assert cfg.param_count() == sum(seen.values())
    big = dataclasses.replace(cfg, tie_embeddings=False)
    assert big.param_count() == cfg.param_count() + cfg.padded_vocab * 64


# --------------------------------------------------------------------------
# the port against the plain reference
# --------------------------------------------------------------------------
def test_forward_matches_the_reference(setting):
    """The no-cache forward (the chunked SSD, blocked attention) against
    the reference's pass; f32 sums in other orders over 6 layers stay
    within 2e-5 of the logit scale (2.6e-6 measured)."""
    cfg, model, params, tok, ref = setting
    with torch.no_grad():
        logits, aux = model.forward(params, {"tokens": tok})
    assert float(aux) == 0.0
    _close(logits, ref, 2e-5)


def test_prefill_then_decode_matches_the_reference(setting):
    """Prefill of S tokens into the cache, then STEPS decode steps (the
    SSD recurrence and the dense decode softmax, the ``ssd_scan`` and
    attention kernels' plain versions) against the reference's pass over
    the whole sequence: the same 2e-5 of the logit scale."""
    cfg, model, params, tok, ref = setting
    with torch.no_grad():
        cache = model.init_cache(2, S + STEPS + 1)
        first, cache = model.prefill(params, {"tokens": tok[:, :S]},
                                     cache=cache)
        outs = [first]
        for t in range(S, S + STEPS):
            lg, cache = model.decode_step(params, cache, tok[:, t:t + 1])
            outs.append(lg)
    assert int(cache["index"]) == S + STEPS
    _close(torch.stack(outs, dim=1), ref[:, S - 1:], 2e-5)


def test_the_zamba2_27b_form_is_kept():
    """zamba2-2.7b's single residual block, one group, no conv bias: the
    published form's pieces stay out of it."""
    cfg = get_config("zamba2-2.7b-reduced")
    model = build_model(cfg, device="cpu")
    p = model.init(model.generator(0))
    assert "shared_attn" in p and "shared_blocks" not in p
    assert "conv_x_bias" not in p["layers"][0]["mamba"]
    assert p["layers"][0]["mamba"]["w_bc"].shape[1] == 2 * cfg.ssm_state_dim
    assert all("hybrid" not in layer for layer in p["layers"])


# --------------------------------------------------------------------------
# the plain reference against transformers' Zamba2ForCausalLM
# --------------------------------------------------------------------------
def _hf_config(transformers, cfg):
    kinds = ["hybrid" if i in cfg.hybrid_layer_ids else "mamba"
             for i in range(cfg.num_layers)]
    return transformers.Zamba2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.num_layers, layers_block_type=kinds,
        mamba_d_state=cfg.ssm_state_dim, mamba_d_conv=cfg.ssm_conv_width,
        mamba_expand=cfg.ssm_expand, mamba_ngroups=cfg.ssm_groups,
        n_mamba_heads=cfg.ssm_num_heads, intermediate_size=cfg.d_ff,
        hidden_act="gelu", num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        num_mem_blocks=cfg.num_mem_blocks, use_shared_attention_adapter=False,
        adapter_rank=cfg.adapter_rank, use_mem_rope=True,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
        time_step_limit=None, tie_word_embeddings=cfg.tie_embeddings)


def _load_hf(hf, params, cfg):
    """The port's tree into ``Zamba2ForCausalLM``: weights transposed to
    (out, in), norms ``1 + scale``, ``gate_up = [w_gate | w_up]``,
    ``in_proj = [z | x | B | C | dt]``, conv channels ``[x | B | C]``."""
    def one(t):
        return 1.0 + t

    sd = {"model.embed_tokens.weight": params["embed"],
          "model.final_layernorm.weight": one(params["final_norm"])}
    apps = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}
    for i, layer in enumerate(params["layers"]):
        m = layer["mamba"]
        pre = (f"model.layers.{i}.mamba_decoder." if i in apps
               else f"model.layers.{i}.")
        sd.update({
            pre + "input_layernorm.weight": one(layer["norm1"]),
            pre + "mamba.in_proj.weight": torch.cat(
                [m["w_zx"], m["w_bc"], m["w_dt"]], dim=1).T,
            pre + "mamba.conv1d.weight": torch.cat(
                [m["conv_x"], m["conv_bc"]], dim=1).T[:, None, :],
            pre + "mamba.conv1d.bias": torch.cat(
                [m["conv_x_bias"], m["conv_bc_bias"]]),
            pre + "mamba.dt_bias": m["dt_bias"], pre + "mamba.A_log":
                m["a_log"], pre + "mamba.D": m["d_skip"],
            pre + "mamba.norm.weight": one(m["norm"]),
            pre + "mamba.out_proj.weight": m["w_out"].T})
        if i in apps:
            j, hyb = apps[i], layer["hybrid"]
            blk = params["shared_blocks"][j % cfg.num_mem_blocks]
            st = f"model.layers.{i}.shared_transformer."
            sd[f"model.layers.{i}.linear.weight"] = hyb["w_out"].T
            sd.update({
                st + "input_layernorm.weight": one(blk["norm1"]),
                st + "pre_ff_layernorm.weight": one(blk["norm2"]),
                st + "self_attn.q_proj.weight": blk["attn"]["wq"].T,
                st + "self_attn.k_proj.weight": blk["attn"]["wk"].T,
                st + "self_attn.v_proj.weight": blk["attn"]["wv"].T,
                st + "self_attn.o_proj.weight": blk["attn"]["wo"].T,
                st + "feed_forward.gate_up_proj.weight": torch.cat(
                    [blk["mlp"]["w_gate"], blk["mlp"]["w_up"]], dim=1).T,
                st + "feed_forward.down_proj.weight": blk["mlp"]["w_down"].T})
            # the block holds the adapters of every application it serves
            for k, layer_k in enumerate(cfg.hybrid_layer_ids):
                if k % cfg.num_mem_blocks == j % cfg.num_mem_blocks:
                    own_k = params["layers"][layer_k]["hybrid"]
                    ad = st + f"feed_forward.gate_up_proj_adapter_list.{k}."
                    sd[ad + "0.weight"] = own_k["adapter_a"].T
                    sd[ad + "1.weight"] = own_k["adapter_b"].T
    own = hf.state_dict()
    missing = [k for k in own if k not in sd and k != "lm_head.weight"]
    assert not missing, missing
    hf.load_state_dict({k: v.contiguous() for k, v in sd.items()},
                       strict=False)
    assert torch.equal(hf.lm_head.weight, params["embed"])


def test_reference_matches_transformers(setting):
    """The reference against ``Zamba2ForCausalLM``'s PyTorch path in f32 on
    the same weights (its dt stays far above the fallback's 1e-3 clamp):
    within 5e-5 of the logit scale, 5e-6 measured (the published code
    sums its SSD and attention in other orders)."""
    transformers = pytest.importorskip("transformers")
    cfg, _, params, tok, ref = setting
    hf = transformers.Zamba2ForCausalLM(_hf_config(transformers, cfg))
    hf.config._attn_implementation = "eager"
    hf.eval()
    _load_hf(hf, params, cfg)
    with torch.no_grad():
        out = hf(input_ids=tok, use_cache=False).logits
    _close(out[..., :cfg.vocab_size], ref, 5e-5)


# --------------------------------------------------------------------------
# the kernels' plain versions
# --------------------------------------------------------------------------
def _ssd_inputs(t, groups, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, h, p, n = 2, 4, 32, 16
    x = torch.randn(b, t, h, p, generator=g)
    dt = torch.rand(b, t, h, generator=g) * 0.5
    a_log = torch.randn(h, generator=g) * 0.3
    bm = torch.randn(b, t, groups, n, generator=g)
    cm = torch.randn(b, t, groups, n, generator=g)
    h0 = torch.randn(b, h, p, n, generator=g)
    return x, dt, a_log, bm, cm, h0


@pytest.mark.parametrize("scan", [ssd_ops.ssd_scan_plain,
                                  ssd_ops.ssd_scan_chunked_plain])
def test_grouped_ssd_scan(scan):
    """G groups equal B and C repeated per head (G = H), one group as
    (B, T, 1, N) equals the shared (B, T, N) bit for bit, and the state
    is written into ``h_out``."""
    x, dt, a_log, bm, cm, h0 = _ssd_inputs(40, 2)
    y, hf = scan(x, dt, a_log, bm, cm, h0)
    per_head = scan(x, dt, a_log, bm.repeat_interleave(2, dim=2),
                    cm.repeat_interleave(2, dim=2), h0)
    torch.testing.assert_close(y, per_head[0], rtol=0, atol=0)
    torch.testing.assert_close(hf, per_head[1], rtol=0, atol=0)
    y0, h_0 = scan(x[:, :, :2], dt[:, :, :2], a_log[:2], bm[:, :, 0],
                   cm[:, :, 0], h0[:, :2])
    assert torch.equal(y[:, :, :2], y0) and torch.equal(hf[:, :2], h_0)
    one = scan(x, dt, a_log, bm[:, :, :1], cm[:, :, :1], h0)
    shared = scan(x, dt, a_log, bm[:, :, 0], cm[:, :, 0], h0)
    assert torch.equal(one[0], shared[0]) and torch.equal(one[1], shared[1])
    out = torch.empty_like(h0)
    _, got = scan(x, dt, a_log, bm, cm, h0, h_out=out)
    assert got is out and torch.equal(out, hf)
    with pytest.raises(ValueError, match="G dividing"):
        ssd_ops._check(x, dt, a_log, bm[:, :, :1].expand(-1, -1, 3, -1),
                       cm[:, :, :1].expand(-1, -1, 3, -1), h0, h0,
                       torch.float32)


def test_attention_plain_versions_take_a_scale_and_d224():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 12, 4, 224, generator=g)
    k = torch.randn(2, 12, 2, 224, generator=g)
    v = torch.randn(2, 12, 2, 224, generator=g)
    scale = 112 ** -0.5
    got = swa_prefill_plain(q, k, v, window=12, scale=scale)
    kk, vv = k.repeat_interleave(2, 2), v.repeat_interleave(2, 2)
    want = F.scaled_dot_product_attention(
        q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
        is_causal=True, scale=scale).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(swa_prefill_plain(q, k, v, window=12),
                       swa_prefill_plain(q, k, v, 12, 224 ** -0.5))
    qd = torch.randn(2, 2, 2, 224, generator=g)
    lengths = torch.tensor([5, 12], dtype=torch.int32)
    out, lse = decode_attention_plain(qd, k, v, lengths, True, scale)
    for b in range(2):
        n = int(lengths[b])
        sc = torch.einsum("kgd,skd->kgs", qd[b], k[b, :n]) * scale
        torch.testing.assert_close(lse[b], torch.logsumexp(sc, -1))
        torch.testing.assert_close(
            out[b], torch.einsum("kgs,skd->kgd", sc.softmax(-1), v[b, :n]))
    assert torch.equal(decode_attention_plain(qd, k, v, lengths),
                       decode_attention_plain(qd, k, v, lengths,
                                              scale=224 ** -0.5))


def test_glu_gate_erf_kind():
    g = torch.Generator().manual_seed(2)
    gate, up = torch.randn(3, 64, generator=g), torch.randn(3, 64, generator=g)
    erf = glu_gate_plain(gate, up, "geglu_erf")
    torch.testing.assert_close(
        erf, 0.5 * gate * (1 + torch.erf(gate / 2 ** 0.5)) * up)
    assert not torch.allclose(erf, glu_gate_plain(gate, up, "geglu"),
                              rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# the serving path's records
# --------------------------------------------------------------------------
def test_a_traced_serve_records_state_bytes_and_step_counts():
    """A traced llm-chat serve of the tiny configuration marks each b's
    gang cache by kind (``sponge.setup.state_bytes``) and each step's
    shared-block applications (``sponge.step_counts``): one per hybrid
    layer in every prefill and every decode step.  (On the CPU no kernel
    runs, so ``ssd_scan``'s launches by body are counted on the card:
    ``tests/test_torch_cuda.py``.)"""
    from repro_torch.core.cost_model import TokenCostModel
    from repro_torch.serving import scenarios
    from repro_torch.serving import token_backend as tb
    from repro_torch.serving.trace import ServeTrace

    cfg, pl, md = tiny_config(), 8, 3
    tr = ServeTrace()
    runner, _, _, _ = tb.make_token_live_server(
        cfg, c_set=(1,), b_set=(1, 2), prompt_len=pl, max_decode=md,
        clock="modeled", tick=0.25, prior_rps=40.0,
        cost=TokenCostModel.smollm_like(), device="cpu", trace=tr)
    batch, _ = scenarios.build_scenario("llm-chat", requests=6, seed=5,
                                        rps=40.0)
    runner.run(tb.scenario_arrivals(batch, 6, 5, pl, md, cfg.vocab_size))
    marks = tr.named("setup.state_bytes")
    assert [m.attrs["b"] for m in marks] == [1, 2]
    h, p, n, g = (cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_dim,
                  cfg.ssm_groups)
    apps = len(cfg.hybrid_layer_ids)
    for m in marks:
        b = m.attrs["b"]
        assert m.attrs["ssd_state"] == 6 * b * h * p * n * 4
        assert m.attrs["conv_window"] == \
            6 * b * 3 * (cfg.d_inner + 2 * g * n) * 4
        assert m.attrs["shared_kv"] == \
            2 * apps * b * (pl + md + 1) * cfg.num_kv_heads * cfg.head_dim * 4
        assert m.attrs["other"] == 0
    steps = {"sponge.prefill": 0, "sponge.decode": 0}
    for m in tr.named("step_counts"):
        parent = tr.records[m.parent].name
        if parent in steps:
            assert m.attrs == {"shared_applications": apps}
            steps[parent] += 1
    assert steps["sponge.prefill"] == len(tr.named("prefill")) > 0
    assert steps["sponge.decode"] == len(tr.named("decode")) > 0


def test_one_counter_table():
    """The kernels' launches, ``ssd_scan``'s launches by body and the
    shared applications are one table (``utils/counters.py``), and the
    capture's two views split it by kind without the serving layer
    naming a model."""
    from repro_torch.kernels import build
    from repro_torch.models import zamba2
    from repro_torch.serving import capture
    from repro_torch.utils import counters

    assert set(capture.launch_counts()) == set(build.SOURCES)
    assert set(capture.event_counts()) == {
        "ssd_scan.recurrence", "ssd_scan.chunked", "shared_applications"}
    assert set(counters.read()) == set(capture.launch_counts()) | set(
        capture.event_counts())
    before = counters.read()
    step = {"ssd_scan": 2, "ssd_scan.recurrence": 2,
            "shared_applications": 13}
    counters.add(step)
    assert counters.delta(counters.read(), before) == step
    after = counters.read()
    assert after["ssd_scan"] == before["ssd_scan"] + 2
    assert after["ssd_scan.recurrence"] == before["ssd_scan.recurrence"] + 2
    assert after["shared_applications"] == before["shared_applications"] + 13
    counters.add(step, -1)
    assert counters.read() == before
    assert zamba2 not in vars(capture).values()
