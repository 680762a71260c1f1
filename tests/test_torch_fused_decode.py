"""The decode step's fused chains on the CPU: ``add_rms_norm``,
``rope_kv_write`` and ``glu_gate``.

On the card each is one CUDA kernel (held to its plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``); on the CPU the
wrappers run their plain versions.  These tests hold each plain version
to the chain it replaced, bit for bit, in bf16 and f32; the decode step
with the residual handed from block to block to the step that added it
at once, logits and cache bit for bit; the number of calls of each
wrapper when the route is forced; and the routes that stay plain (MLA,
M-RoPE, a mesh, f32, the CPU).
"""
import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.add_rms_norm import ops as norm_ops
from repro_torch.kernels.glu_gate import ops as gate_ops
from repro_torch.kernels.rope_kv_write import ops as rope_ops
from repro_torch.models import api, build_model
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import apply_rope
from repro_torch.utils import counters

DTYPES = (torch.bfloat16, torch.float32)


def draw(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def rms_norm_chain(x, scale, eps):
    """The norm as the decode step ran it before the fused route."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


# -- each plain version is the chain it replaced --------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_y", [True, False])
def test_add_rms_norm_plain_is_the_add_then_the_norm(dtype, with_y):
    x, y = draw((3, 1, 80), dtype, 0), draw((3, 1, 80), dtype, 1)
    scale = draw((80,), dtype, 2) * 0.1
    x_new, h = norm_ops.add_rms_norm_plain(x, y if with_y else None, scale,
                                           1e-5)
    want_x = x + y if with_y else x
    assert torch.equal(x_new, want_x) and x_new.dtype == dtype
    assert torch.equal(h, rms_norm_chain(want_x, scale, 1e-5))
    # the wrapper takes the plain version on the CPU and counts nothing
    before = counters.read()["add_rms_norm"]
    x2, h2 = norm_ops.add_rms_norm(x, y if with_y else None, scale, 1e-5)
    assert torch.equal(x2, x_new) and torch.equal(h2, h)
    assert counters.read()["add_rms_norm"] == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_glu_gate_plain_is_the_activation_then_the_product(dtype, kind):
    gate, up = draw((4, 1, 96), dtype, 3) * 3, draw((4, 1, 96), dtype, 4)
    act = F.silu(gate) if kind == "swiglu" else \
        F.gelu(gate, approximate="tanh")
    out = gate_ops.glu_gate_plain(gate, up, kind)
    assert torch.equal(out, act * up) and out.dtype == dtype
    before = counters.read()["glu_gate"]
    assert torch.equal(gate_ops.glu_gate(gate, up, kind), out)
    assert counters.read()["glu_gate"] == before
    with pytest.raises(ValueError):
        gate_ops.glu_gate_plain(gate, up, "gelu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,index", [(0, 5), (8, 5), (8, 8), (8, 21)])
def test_rope_kv_write_plain_is_rope_then_the_two_writes(dtype, window,
                                                         index):
    """Full cache and ring buffer, before and past the ring's wrap."""
    b, h, kvh, d, s = 2, 4, 2, 80, 8 if window else 12
    q, k, v = (draw((b, 1, n, d), dtype, seed)
               for seed, n in ((5, h), (6, kvh), (7, kvh)))
    ck0, cv0 = draw((b, s, kvh, d), dtype, 8), draw((b, s, kvh, d), dtype, 9)
    idx = torch.tensor(index, dtype=torch.int32)
    ck, cv = ck0.clone(), cv0.clone()
    q_out = rope_ops.rope_kv_write_plain(q, k, v, idx, ck, cv, 1e4, window)
    pos = torch.full((b, 1), index, dtype=torch.long)
    slot = index % s if window else index
    want_ck, want_cv = ck0.clone(), cv0.clone()
    want_ck[:, slot] = apply_rope(k, pos, 1e4)[:, 0]
    want_cv[:, slot] = v[:, 0]
    assert torch.equal(q_out, apply_rope(q, pos, 1e4).reshape(b, kvh,
                                                               h // kvh, d))
    assert torch.equal(ck, want_ck) and torch.equal(cv, want_cv)
    before = counters.read()["rope_kv_write"]
    ck2, cv2 = ck0.clone(), cv0.clone()
    assert torch.equal(rope_ops.rope_kv_write(q, k, v, idx, ck2, cv2, 1e4,
                                              window), q_out)
    assert torch.equal(ck2, ck) and torch.equal(cv2, cv)
    assert counters.read()["rope_kv_write"] == before


def test_wrappers_raise_off_the_cpu_and_the_card():
    meta = torch.empty((2, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        norm_ops.add_rms_norm(meta, None, torch.empty(8, device="meta"), 1e-5)
    with pytest.raises(ValueError, match="no kernel"):
        gate_ops.glu_gate(meta, meta, "swiglu")
    q = torch.empty((1, 1, 2, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rope_ops.rope_kv_write(q, q, q, torch.empty((), device="meta"), q, q,
                               1e4, 0)


# -- the decode step ------------------------------------------------------

def danube_shaped(dtype, **over):
    """h2o-danube-1.8b's stack at two layers: GQA over a sliding-window
    ring, head_dim 80, SwiGLU, the kernel routes on (their plain
    versions on the CPU)."""
    return dataclasses.replace(
        get_config("h2o-danube-1.8b-reduced"), num_heads=4, num_kv_heads=2,
        head_dim=80, dtype=dtype, use_pallas_prefill=True,
        use_pallas_decode=True, **over)


def undeferred_step(params, cache, token, cfg):
    """The decode step as it ran before the residual was handed on: each
    block adds its outputs at once."""
    index = cache["index"]
    b = token.shape[0]
    positions = index.long().expand(b, 1)
    x = api._embed(params, cfg, token.long(), positions)
    for i, p in enumerate(params["layers"]):
        h = rms_norm_chain(x, p["norm1"], cfg.norm_eps)
        y, _ = attn.attention_decode(p["attn"], h, api._layer_cache(cache, i),
                                     index, positions, cfg,
                                     window=cfg.window_size)
        x = x + y
        h = rms_norm_chain(x, p["norm2"], cfg.norm_eps)
        x = x + mlp_mod.mlp_fwd(p["mlp"], h, cfg.mlp_kind)
    x = rms_norm_chain(x, params["final_norm"], cfg.norm_eps)
    logits = api._head(params, cfg, x)
    index.add_(1)
    return logits[:, 0], cache


def run_steps(step, cfg, seed=0, b=2, prompt=12, steps=8):
    """A prompt of ``prompt`` tokens, then ``steps`` greedy decode steps
    (past the 16-slot ring's wrap): every step's logits and the cache."""
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(seed))
    g = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g)
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  cache_len=prompt + steps + 1)
    out = []
    for _ in range(steps):
        tok = logits.argmax(-1, keepdim=True)
        logits, cache = step(params, cache, tok, cfg)
        out.append(logits)
    return torch.stack(out), cache


def force_route(monkeypatch):
    monkeypatch.setattr(tfm, "fused_decode", lambda cfg, x, mesh=None: True)


def cache_equal(a, b):
    return all(cache_equal(a[k], b[k]) if isinstance(a[k], dict)
               else torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("forced", [False, True])
def test_decode_step_equals_the_undeferred_step(dtype, forced, monkeypatch):
    """Logits and cache bit for bit, through the ring's wrap; forced,
    with each fused wrapper in its chain's place."""
    cfg = danube_shaped(dtype)
    ref_logits, ref_cache = run_steps(undeferred_step, cfg)
    if forced:
        force_route(monkeypatch)
    logits, cache = run_steps(api.decode_step, cfg)
    assert int(cache["index"]) == 12 + 8 > cfg.window_size
    assert torch.equal(logits, ref_logits)
    assert cache_equal(cache, ref_cache)


def spy(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


def count_calls(monkeypatch, cfg, forced=True):
    counts = {}
    spy(monkeypatch, tfm, "add_rms_norm", counts)
    spy(monkeypatch, attn, "rope_kv_write", counts)
    spy(monkeypatch, mlp_mod, "glu_gate", counts)
    if forced:
        force_route(monkeypatch)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    cache = model.init_cache(2, 8)
    batch = {"tokens": torch.ones((2, 4), dtype=torch.long)}
    if cfg.is_encoder_decoder:
        g = torch.Generator().manual_seed(2)
        batch["enc_embeds"] = torch.randn(
            2, cfg.encoder_seq_len, cfg.d_model, generator=g).to(
                torch.bfloat16)
    model.prefill(params, batch, cache=cache)
    assert counts == {}                # prefill never takes the route
    logits, _ = model.decode_step(params, cache,
                                  torch.ones((2, 1), dtype=torch.long))
    return counts, logits


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_decode_step_calls_each_wrapper_per_layer(dtype, monkeypatch):
    cfg = danube_shaped(dtype, num_layers=3, blocks=("swa+mlp",) * 3)
    counts, _ = count_calls(monkeypatch, cfg)
    layers = cfg.num_layers
    assert counts == {"add_rms_norm": 2 * layers + 1,
                      "rope_kv_write": layers, "glu_gate": layers}


def test_the_route_is_off_unless_bf16_on_the_card_without_a_mesh():
    cfg = danube_shaped("bfloat16")
    card_bf16 = types.SimpleNamespace(device=torch.device("cuda", 0),
                                      dtype=torch.bfloat16)
    card_f32 = types.SimpleNamespace(device=torch.device("cuda", 0),
                                     dtype=torch.float32)
    assert tfm.fused_decode(cfg, card_bf16)
    assert not tfm.fused_decode(cfg, card_bf16, mesh=object())
    assert not tfm.fused_decode(cfg, card_f32)
    assert not tfm.fused_decode(cfg, torch.zeros(2, dtype=torch.bfloat16))
    assert not tfm.fused_decode(
        dataclasses.replace(cfg, use_pallas_decode=False), card_bf16)


@pytest.mark.parametrize("arch,rope,gate", [
    ("deepseek-v3-671b-reduced", 0, 1),       # MLA; one dense MLP layer
    ("kimi-k2-1t-a32b-reduced", 2, 1),        # GQA; one dense MLP layer
    ("rwkv6-1.6b-reduced", 0, 0),             # no RoPE, channel mix
    ("zamba2-2.7b-reduced", 2, 2),            # the shared block, twice
    ("whisper-large-v3-reduced", 0, 0),       # learned positions, GELU
])
def test_forced_route_keeps_other_stacks_plain(arch, rope, gate,
                                               monkeypatch):
    """MLA and learned or no positions keep their RoPE and cache writes
    plain; only a SwiGLU / GeGLU MLP takes the gate; every norm is
    fused, and the step's logits are the plain route's bit for bit."""
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                              use_pallas_decode=True)
    plain_logits = None
    with monkeypatch.context() as m:
        _, plain_logits = count_calls(m, cfg, forced=False)
    counts, logits = count_calls(monkeypatch, cfg)
    assert counts.get("rope_kv_write", 0) == rope
    assert counts.get("glu_gate", 0) == gate
    assert counts["add_rms_norm"] > cfg.num_layers
    assert torch.equal(logits, plain_logits)


def test_forced_route_keeps_mrope_plain(monkeypatch):
    """Qwen2-VL's M-RoPE: the cache write and RoPE stay plain, the norms
    and the SwiGLU gate take the route, the logits do not move."""
    cfg = dataclasses.replace(get_config("qwen2-vl-2b-reduced"),
                              dtype="bfloat16", use_pallas_decode=True)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    b, p = 2, cfg.num_patch_tokens
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, 4), generator=g),
             "prefix_embeds": torch.randn(b, p, cfg.d_model,
                                          generator=g).to(torch.bfloat16),
             "mrope_positions": torch.arange(p + 4).expand(3, b, p + 4)}
    tok = torch.ones((b, 1), dtype=torch.long)

    def step():
        cache = model.init_cache(b, p + 6)
        model.prefill(params, batch, cache=cache)
        return model.decode_step(params, cache, tok)[0]
    plain = step()
    counts = {}
    spy(monkeypatch, tfm, "add_rms_norm", counts)
    spy(monkeypatch, attn, "rope_kv_write", counts)
    spy(monkeypatch, mlp_mod, "glu_gate", counts)
    force_route(monkeypatch)
    assert torch.equal(step(), plain)
    layers = cfg.num_layers
    assert counts == {"add_rms_norm": 2 * layers + 1, "glu_gate": layers}
