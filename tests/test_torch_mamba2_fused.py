"""The Mamba2 decode step's fused chains on the CPU: ``mamba2_conv_step``
and ``mamba2_gate_norm``.

On the card each is one CUDA kernel (held to its plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``); on the CPU the
wrappers run their plain versions.  These tests hold each plain version
to the chain it replaced, bit for bit, in bf16 and f32, with one group
and no conv biases (zamba2-2.7b's form) and with two groups and biases
(published Zamba2's), the windows shifted in place; a decode step of a
tiny model of each form with the route forced, against the step as it
ran before (logits, conv windows and SSD state bit for bit); the calls
of each wrapper a step; and the routes that stay plain.
"""
import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.add_rms_norm.ops import rms_norm
from repro_torch.kernels.mamba2_conv_step import ops as conv_ops
from repro_torch.kernels.mamba2_gate_norm import ops as gate_ops
from repro_torch.models import build_model
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tfm
from repro_torch.models.common import linear
from repro_torch.utils import counters

DTYPES = (torch.bfloat16, torch.float32)
# (groups, conv biases): zamba2-2.7b's form and published Zamba2's
FORMS = {"g1": (1, False), "g2_bias": (2, True)}
B, DI, N, H, W = 2, 32, 8, 4, 4


def draw(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def layer(dtype, groups, bias, seed=0):
    """One layer's conv, dt and norm leaves, drawn away from their init
    in ``dtype`` (the benchmark draws every leaf in bf16)."""
    cbc = 2 * groups * N
    p = {"conv_x": draw((W, DI), dtype, seed, 0.5),
         "conv_bc": draw((W, cbc), dtype, seed + 1, 0.5),
         "dt_bias": draw((H,), dtype, seed + 2),
         "a_log": draw((H,), dtype, seed + 3, 0.3),
         "d_skip": draw((H,), dtype, seed + 4),
         "norm": draw((DI,), dtype, seed + 5, 0.1)}
    if bias:
        p["conv_x_bias"] = draw((DI,), dtype, seed + 6, 0.1)
        p["conv_bc_bias"] = draw((cbc,), dtype, seed + 7, 0.1)
    return p


def old_convs(p, xin, bcin, state):
    """The conv chain as the decode step ran it before the fused route."""
    def conv(x, w, st, bias):
        xp = torch.cat([st, x], dim=1)
        y = 0
        for i in range(w.shape[0]):
            y = y + xp[:, i:i + 1] * w[i]
        if bias is not None:
            y = y + bias
        return F.silu(y), xp[:, -(w.shape[0] - 1):]
    xc, cx = conv(xin, p["conv_x"], state["conv_x"], p.get("conv_x_bias"))
    bcc, cbc = conv(bcin, p["conv_bc"], state["conv_bc"],
                    p.get("conv_bc_bias"))
    return xc, bcc, cx, cbc


def old_split(bcc, groups, n):
    if groups == 1:
        return bcc[..., :n], bcc[..., n:]
    return (bcc[..., :groups * n].unflatten(-1, (groups, n)),
            bcc[..., groups * n:].unflatten(-1, (groups, n)))


def old_gate_norm(y, xc, p, z, groups, eps):
    """The chain after the scan as the decode step ran it before: y (B,
    1, H, P) f32, xc (B, 1, H P)."""
    b, _, h, hp = y.shape
    xh = xc[:, 0].unflatten(-1, (h, -1)).float()
    y = y[:, 0] + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, h * hp).to(z.dtype)
    if groups == 1:
        return rms_norm(y * F.silu(z), p["norm"], eps)
    v = (y * F.silu(z)).unflatten(-1, (groups, -1))
    return rms_norm(v, p["norm"].view(groups, -1), eps).flatten(-2)


def inputs(dtype, groups, seed=10):
    zx = draw((B, 1, 2 * DI), dtype, seed, 2.0)
    bcin = draw((B, 1, 2 * groups * N), dtype, seed + 1, 2.0)
    dt_raw = draw((B, 1, H), dtype, seed + 2, 4.0)
    state = {"conv_x": draw((B, W - 1, DI), dtype, seed + 3),
             "conv_bc": draw((B, W - 1, 2 * groups * N), dtype, seed + 4)}
    return zx, bcin, dt_raw, state


# -- each plain version is the chain it replaced --------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("in_place", [True, False])
def test_conv_step_plain_is_the_chain_it_replaced(dtype, form, in_place):
    """xc, B, C, dt, a_log and the shifted windows bit for bit; in place,
    the windows of ``state`` itself are the shifted ones, else ``state``
    is left as it was."""
    groups, bias = FORMS[form]
    p = layer(dtype, groups, bias)
    zx, bcin, dt_raw, state = inputs(dtype, groups)
    before = {k: v.clone() for k, v in state.items()}
    want_xc, bcc, want_cx, want_cbc = old_convs(p, zx[..., DI:], bcin, before)
    want_b, want_c = old_split(bcc, groups, N)
    want_dt = F.softplus(dt_raw.float() + p["dt_bias"])
    out = state if in_place else None
    xc, bm, cm, dt, a_log, cx, cbc = conv_ops.mamba2_conv_step_plain(
        p, zx[..., DI:], bcin, dt_raw, state, groups, out)
    for got, want in ((xc, want_xc), (bm, want_b), (cm, want_c),
                      (dt, want_dt), (a_log, p["a_log"].float()),
                      (cx, want_cx), (cbc, want_cbc)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
    assert bm.shape == ((B, 1, N) if groups == 1 else (B, 1, groups, N))
    if in_place:
        assert cx.data_ptr() == state["conv_x"].data_ptr()
        assert torch.equal(state["conv_x"][:, :-1], before["conv_x"][:, 1:])
        assert torch.equal(state["conv_x"][:, -1], zx[:, 0, DI:])
    else:
        assert all(torch.equal(state[k], before[k]) for k in state)
    # the wrapper takes the plain version on the CPU and counts nothing
    n = counters.read()["mamba2_conv_step"]
    again = conv_ops.mamba2_conv_step(p, zx[..., DI:], bcin, dt_raw, before,
                                      groups)
    assert all(torch.equal(a, b) for a, b in zip(again, (
        want_xc, bm, cm, dt, a_log, want_cx, want_cbc)))
    assert counters.read()["mamba2_conv_step"] == n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_gate_norm_plain_is_the_chain_it_replaced(dtype, form):
    groups, _ = FORMS[form]
    p = layer(dtype, groups, False)
    zx = draw((B, 1, 2 * DI), dtype, 20, 2.0)
    xc = draw((B, 1, DI), dtype, 21)
    y = draw((B, 1, H, DI // H), torch.float32, 22)
    xh = xc.unflatten(-1, (H, -1))
    got = gate_ops.mamba2_gate_norm_plain(y, xh, p["d_skip"], zx[..., :DI],
                                          p["norm"], groups, 1e-5)
    want = old_gate_norm(y, xc, p, zx[..., :DI], groups, 1e-5)
    assert got.shape == (B, 1, DI) and got.dtype == dtype
    assert torch.equal(got, want)
    n = counters.read()["mamba2_gate_norm"]
    assert torch.equal(gate_ops.mamba2_gate_norm(
        y, xh, p["d_skip"], zx[..., :DI], p["norm"], groups, 1e-5), want)
    assert counters.read()["mamba2_gate_norm"] == n


def test_wrappers_raise_off_the_cpu_and_the_card():
    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    p = {"conv_x": meta(W, DI), "conv_bc": meta(W, 2 * N),
         "dt_bias": meta(H), "a_log": meta(H)}
    state = {"conv_x": meta(1, W - 1, DI), "conv_bc": meta(1, W - 1, 2 * N)}
    with pytest.raises(ValueError, match="no kernel"):
        conv_ops.mamba2_conv_step(p, meta(1, 1, DI), meta(1, 1, 2 * N),
                                  meta(1, 1, H), state, 1)
    with pytest.raises(ValueError, match="no kernel"):
        gate_ops.mamba2_gate_norm(meta(1, 1, H, DI // H, dtype=torch.float32),
                                  meta(1, 1, H, DI // H), meta(H),
                                  meta(1, 1, DI), meta(DI), 1, 1e-5)


# -- the decode step ------------------------------------------------------

def tiny(arch, dtype):
    """A tiny model of each form, the kernel routes on (their plain
    versions on the CPU): published Zamba2 (two groups, conv biases, two
    shared blocks) at d 64 over 4 layers, and zamba2-2.7b's reduced
    stack (one group, no biases, the shared block every 2 layers)."""
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(
            get_config("zamba2-7b"), name="zamba2-7b-tiny", num_layers=4,
            blocks=("mamba2+none",) * 4, d_model=64, num_heads=4,
            num_kv_heads=4, head_dim=32, d_ff=96, vocab_size=128,
            ssm_state_dim=16, ssm_head_dim=16, hybrid_layer_ids=(1, 3),
            adapter_rank=8, remat=False)
    else:
        cfg = get_config("zamba2-2.7b-reduced")
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                               use_pallas_prefill=True,
                               use_pallas_decode=True)


def tiny_params(cfg, seed=0):
    """The init with every vector leaf (conv biases, dt bias, A, D, the
    norms) moved away from it."""
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(seed))
    gen = torch.Generator().manual_seed(seed + 1)

    def walk(node):
        for v in (node.values() if isinstance(node, dict) else node):
            if isinstance(v, (dict, list)):
                walk(v)
            elif v.dim() == 1:
                v.add_((0.1 * torch.randn(v.shape, generator=gen)).to(v.dtype))
    walk(params)
    return model, params


def old_decode(params, x, cfg, state, *, kernel=False, out=None, mesh=None,
               fused=False):
    """``mamba2_decode`` as it ran before the fused route."""
    h, p, di = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.d_inner
    zx = linear(x, params["w_zx"])
    dt = F.softplus(linear(x, params["w_dt"]).float() + params["dt_bias"])
    xc, bcc, conv_x, conv_bc = old_convs(params, zx[..., di:],
                                         linear(x, params["w_bc"]), state)
    bm, cm = old_split(bcc, cfg.ssm_groups, cfg.ssm_state_dim)
    y, _ = m2.ssd(xc.unflatten(-1, (h, p)), dt, params["a_log"].float(), bm,
                  cm, state["h"], kernel=kernel, out=out["h"],
                  y_dtype=torch.float32)
    y = old_gate_norm(y, xc, params, zx[..., :di], cfg.ssm_groups,
                      cfg.norm_eps)
    out["conv_x"].copy_(conv_x)
    out["conv_bc"].copy_(conv_bc)
    return linear(y, params["w_out"]), out


def run_steps(cfg, monkeypatch, route, steps=4, b=2, prompt=6):
    """A prompt, then greedy decode steps: each step's logits and the
    cache.  ``route``: "old" (the step as it ran before), "forced" (the
    fused wrappers in the chains' place) or "plain"."""
    with monkeypatch.context() as m:
        if route == "old":
            m.setattr(m2, "mamba2_decode", old_decode)
        if route == "forced":
            m.setattr(tfm, "fused_decode", lambda cfg, x, mesh=None: True)
        model, params = tiny_params(cfg)
        g = torch.Generator().manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (b, prompt), generator=g)
        logits, cache = model.prefill(params, {"tokens": tokens},
                                      cache_len=prompt + steps + 1)
        out = []
        for _ in range(steps):
            logits, cache = model.decode_step(
                params, cache, logits.argmax(-1, keepdim=True))
            out.append(logits)
    return torch.stack(out), cache


@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forced_decode_step_equals_the_step_before(arch, dtype, monkeypatch):
    """Logits, conv windows and SSD state bit for bit."""
    cfg = tiny(arch, dtype)
    ref_logits, ref_cache = run_steps(cfg, monkeypatch, "old")
    logits, cache = run_steps(cfg, monkeypatch, "forced")
    assert torch.equal(logits, ref_logits)
    for k in ("conv_x", "conv_bc", "h"):
        assert torch.equal(cache["ssm"][k], ref_cache["ssm"][k])


def count_calls(cfg, monkeypatch, forced):
    """Calls of each wrapper through one prefill and one decode step."""
    counts = {}
    for name in ("mamba2_conv_step", "mamba2_gate_norm"):
        fn = getattr(m2, name)

        def counted(*args, fn=fn, name=name, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(m2, name, counted)
    if forced:
        monkeypatch.setattr(tfm, "fused_decode",
                            lambda cfg, x, mesh=None: True)
    model, params = tiny_params(cfg)
    cache = model.init_cache(2, 8)
    model.prefill(params, {"tokens": torch.ones((2, 4), dtype=torch.long)},
                  cache=cache)
    prefill = dict(counts)
    model.decode_step(params, cache, torch.ones((2, 1), dtype=torch.long))
    return prefill, counts


@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-2.7b"])
def test_forced_step_calls_each_wrapper_once_a_mamba2_layer(arch,
                                                            monkeypatch):
    cfg = tiny(arch, "bfloat16")
    prefill, counts = count_calls(cfg, monkeypatch, forced=True)
    assert prefill == {}                # prefill never takes the route
    assert counts == {"mamba2_conv_step": cfg.num_layers,
                      "mamba2_gate_norm": cfg.num_layers}


@pytest.mark.parametrize("where", ["cpu", "card_f32", "card_mesh"])
def test_the_route_stays_plain_off_bf16_on_the_card(where, monkeypatch):
    """The CPU calls neither wrapper; f32 on the card and a mesh are off
    ``fused_decode``'s route, which the mixer follows."""
    cfg = tiny("zamba2-7b", "bfloat16")
    if where == "cpu":
        _, counts = count_calls(cfg, monkeypatch, forced=False)
        assert counts == {}
        return
    dtype = torch.float32 if where == "card_f32" else torch.bfloat16
    x = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=dtype)
    assert not tfm.fused_decode(cfg, x, None if where == "card_f32"
                                else object())
