"""The decode step's weight products on the CPU: ``decode_gemm`` and the
route to it, ``models.common.decode_linear``.

On the card ``decode_gemm`` is one CUDA kernel (held to its plain version
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``); on the CPU the
wrapper runs its plain version, which is ``linear`` itself.  These tests
hold the plain version to ``linear`` and to an f64 product at every
product shape of zamba2-7b's and h2o-danube-1.8b's decode steps; the
three in-projections of a Mamba2 layer as one call against the three
products; the parameters a decode step reads (their keys, shapes and
storage: nothing is copied or added, and ``params_from_jax`` gives the
same tree as the init); which products the route sends to the kernel
(bf16 decode steps of at most 16 rows on ``fused_decode``'s route) and
which to ``linear`` (prefill, f32, a mesh, more than 16 rows, shapes the
kernel does not take), with the calls a decode step makes; and the
split of K over a cluster chosen from the shapes.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.kernels.decode_gemm import ops as dg
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.utils import counters

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# every weight product of a decode step: (K, (N, ...)); the in-projection's
# three weights read one input
SHAPES = {
    "zamba2_in_proj": (3584, (14336, 256, 112)),
    "zamba2_w_out": (7168, (3584,)),
    "zamba2_qkv": (7168, (7168,)),
    "zamba2_gate_up": (3584, (14336,)),
    "zamba2_down": (14336, (3584,)),
    "zamba2_hybrid_out": (3584, (3584,)),
    "zamba2_adapter_a": (3584, (128,)),
    "zamba2_adapter_b": (128, (28672,)),
    "zamba2_head": (3584, (32000,)),
    "danube_q_o": (2560, (2560,)),
    "danube_kv": (2560, (640,)),
    "danube_gate_up": (2560, (6912,)),
    "danube_down": (6912, (2560,)),
    "danube_head": (2560, (32000,)),
}


def draw(shape, dtype, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def operands(k, ns, rows, dtype, seed=0):
    x = draw((rows, 1, k), dtype, seed)
    ws = [draw((k, n), dtype, seed + 1 + i, k ** -0.5)
          for i, n in enumerate(ns)]
    return x, ws


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_linear_at_the_main_path_shapes(shape, rows, dtype):
    """Each output is ``linear``'s bit for bit, (rows, 1, N) in x's
    dtype, and within the dtype's tolerance of the f64 product on a
    sample of 64 columns."""
    k, ns = SHAPES[shape]
    x, ws = operands(k, ns, rows, dtype)
    got = dg.decode_gemm(x, ws)
    assert len(got) == len(ws)
    cols = np.random.default_rng(0)
    for y, w in zip(got, ws):
        assert y.shape == (rows, 1, w.shape[1]) and y.dtype == dtype
        assert torch.equal(y, common.linear(x, w))
        pick = torch.from_numpy(cols.choice(w.shape[1], 64, replace=False))
        ref = x.double() @ w[:, pick].double()
        np.testing.assert_allclose(y[..., pick].double().numpy(), ref.numpy(),
                                   **TOL[dtype])


@pytest.fixture
def calls(monkeypatch):
    """Every ``decode_gemm`` call ``decode_linear`` makes: (rows of x,
    the weights' shapes)."""
    seen = []

    def record(x, ws):
        seen.append((x.numel() // x.shape[-1], [tuple(w.shape) for w in ws]))
        return dg.decode_gemm(x, ws)
    monkeypatch.setattr(common, "decode_gemm", record)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 16])
def test_merged_in_projection_gives_the_three_products(dtype, rows, calls):
    """z, x, B|C and dt of one call over ``w_zx``, ``w_bc`` and ``w_dt``
    equal the three products (zamba2-7b's widths): one ``decode_gemm``
    call in bf16, three ``linear`` in f32."""
    k, ns = SHAPES["zamba2_in_proj"]
    x, ws = operands(k, ns, rows, dtype, seed=3)
    zx, bc, dt = common.decode_linear(x, *ws, fused=True)
    di = ns[0] // 2
    want = [common.linear(x, w) for w in ws]
    for got, ref in ((zx[..., :di], want[0][..., :di]),
                     (zx[..., di:], want[0][..., di:]), (bc, want[1]),
                     (dt, want[2])):
        assert got.shape == ref.shape and torch.equal(got, ref)
    np.testing.assert_allclose(
        dt.double().numpy(), (x.double() @ ws[2].double()).numpy(),
        **TOL[dtype])
    assert calls == ([(rows, [(k, n) for n in ns])]
                     if dtype == torch.bfloat16 else [])


def tiny(arch, dtype):
    """Published Zamba2 at d 64 over 4 layers (two groups, two shared
    blocks over two hybrid layers) and the reduced h2o-danube-1.8b and
    zamba2-2.7b, on both kernel routes."""
    if arch == "zamba2-7b":
        cfg = dataclasses.replace(
            get_config("zamba2-7b"), name="zamba2-7b-tiny", num_layers=4,
            blocks=("mamba2+none",) * 4, d_model=64, num_heads=4,
            num_kv_heads=4, head_dim=32, d_ff=96, vocab_size=128,
            ssm_state_dim=16, ssm_head_dim=16, hybrid_layer_ids=(1, 3),
            adapter_rank=8, remat=False)
    else:
        cfg = get_config(f"{arch}-reduced")
    return dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                               use_pallas_prefill=True,
                               use_pallas_decode=True)


def smoke():
    """``chip_smoke.py``, whose ``decode_gemm_per_step`` the card's serve
    checks hold every decode step to."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves(sub, path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in leaves(sub, path + (i,)).items()}
    return {path: tree}


def serve_steps(model, params, steps=3, b=2, prompt=5):
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, prompt), generator=g)
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  cache_len=prompt + steps + 1)
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache,
                                          logits.argmax(-1, keepdim=True))
    return logits


@pytest.mark.parametrize("arch", ["zamba2-7b", "zamba2-2.7b",
                                  "h2o-danube-1.8b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_route_calls_and_params_left_as_they_are(arch, dtype, calls,
                                                 monkeypatch):
    """With the route forced, a bf16 decode step makes one
    ``decode_gemm`` call a product group (``chip_smoke.py``
    ``decode_gemm_per_step``: what the card's serve checks), each of at
    most 16 rows, and the prefill none; f32 makes none.  Every parameter
    keeps its key, shape, storage and values: the products read the
    weights in place (a Mamba2 layer's ``w_zx``, ``w_bc`` and ``w_dt``
    too), nothing is copied or added."""
    monkeypatch.setattr(tfm, "fused_decode", lambda cfg, x, mesh=None: True)
    cfg = tiny(arch, dtype)
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    before = {k: (tuple(v.shape), v.data_ptr(), v.clone())
              for k, v in leaves(params).items()}
    steps = 3
    serve_steps(model, params, steps)
    want = (smoke().decode_gemm_per_step(cfg) * steps
            if dtype == "bfloat16" else 0)
    assert len(calls) == want
    assert all(rows == 2 for rows, _ in calls)
    if dtype == "bfloat16" and cfg.blocks[0] == "mamba2+none":
        mamba = params["layers"][0]["mamba"]
        assert [tuple(mamba[k].shape) for k in ("w_zx", "w_bc", "w_dt")] \
            in [ws for _, ws in calls]
    after = leaves(params)
    assert set(after) == set(before)
    for k, (shape, ptr, value) in before.items():
        assert tuple(after[k].shape) == shape and after[k].data_ptr() == ptr
        assert torch.equal(after[k], value), k


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b", "rwkv6-1.6b",
                                  "qwen2-vl-2b", "whisper-large-v3",
                                  "kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_route_calls_a_step_of_every_block_kind(arch, calls, monkeypatch):
    """The forced bf16 route's ``decode_gemm`` calls a step, for every
    block kind the card's serve checks count (GQA attention, SwiGLU,
    GeGLU and GELU MLPs, RWKV-6 and MLA mixers and MoE layers, which keep
    cuBLAS, M-RoPE, cross-attention, an untied head), are
    ``chip_smoke.py``'s ``decode_gemm_per_step``: the reduced models,
    the MoE ones cut to their dense and their MoE block."""
    monkeypatch.setattr(tfm, "fused_decode", lambda cfg, x, mesh=None: True)
    cs = smoke()
    cfg = tiny(arch, "bfloat16")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, num_layers=2, first_k_dense=1,
                                  blocks=cfg.blocks[:1] + cfg.blocks[-1:])
    model = build_model(cfg, device="cpu")
    params = model.init(model.generator(0))
    batch = cs.vlm_audio_batch(cfg, 2, 4, torch.device("cpu"), 1)
    steps = 2
    with torch.inference_mode():
        lg, cache = model.prefill(params, batch,
                                  cache_len=cfg.num_patch_tokens + 4 + steps)
        assert calls == []
        for step in range(steps):
            tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            lg, cache = model.decode_step(params, cache, tok.view(-1, 1),
                                          cs.next_mrope(batch, step))
    assert len(calls) == cs.decode_gemm_per_step(cfg) * steps > 0
    assert all(rows == 2 for rows, _ in calls)


def test_params_from_jax_keeps_the_tree_the_decode_step_reads():
    """The reference's zamba2-2.7b tree converts to the init's keys and
    shapes (``w_zx``, ``w_bc``, ``w_dt`` and ``w_out`` apart, as stored),
    and a forced bf16 decode step over it leaves every leaf in place."""
    cfg = tiny("zamba2-2.7b", "bfloat16")
    from repro.configs import get_config as jax_config
    jcfg = dataclasses.replace(jax_config("zamba2-2.7b-reduced"),
                               dtype="bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_build(jcfg).init(jax.random.key(0)))
    params = params_from_jax(tree, cfg, device="cpu")
    fresh = build_model(cfg, device="cpu").init(torch.Generator())
    got, want = leaves(params), leaves(fresh)
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in got)
    assert {"w_zx", "w_bc", "w_dt", "w_out"} <= set(params["layers"][0]
                                                    ["mamba"])
    ptrs = {k: v.data_ptr() for k, v in got.items()}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tfm, "fused_decode", lambda cfg, x, mesh=None: True)
        serve_steps(build_model(cfg, device="cpu"), params, steps=2)
    assert {k: v.data_ptr() for k, v in leaves(params).items()} == ptrs


@pytest.mark.parametrize("case", ["prefill", "f32", "mesh", "17_rows",
                                  "n_not_multiple_of_8", "16_rows",
                                  "tied_head"])
def test_route_predicate(case, calls):
    """``decode_linear`` sends to the kernel only a product on the fused
    route (never prefill, f32 or a mesh: ``fused`` is False there) of at
    most 16 bf16 rows whose weights the kernel takes; the rest go to
    ``linear``, with the same result."""
    bf = torch.bfloat16
    rows = {"17_rows": 17, "prefill": 16}.get(case, 4)
    dtype = torch.float32 if case == "f32" else bf
    x = draw((rows, 1, 64), dtype, 1)
    w = draw((64, 60 if case == "n_not_multiple_of_8" else 48), dtype, 2)
    fused = case not in ("prefill", "mesh")
    if case == "mesh":
        cfg = dataclasses.replace(get_config("h2o-danube-1.8b-reduced"),
                                  use_pallas_decode=True)
        fused = tfm.fused_decode(cfg, x, mesh=object())
    if case == "tied_head":
        w = draw((48, 64), bf, 2).T
    y = common.decode_linear(x, w, fused=fused)
    assert torch.equal(y, common.linear(x, w))
    kernel = case in ("16_rows", "tied_head")
    assert len(calls) == int(kernel)
    assert dg.takes_kernel(x, [w]) == (case not in ("f32", "17_rows",
                                                    "n_not_multiple_of_8"))


def test_takes_kernel_layouts():
    """Row-major (K, N) weights, up to three; one transposed (N, K)
    weight alone, not beside another; 16-byte alignment; K and N
    multiples of 8; bf16; 1 to 16 rows."""
    bf = torch.bfloat16
    x = torch.zeros(2, 1, 64, dtype=bf)
    w = torch.zeros(64, 64, dtype=bf)
    t = torch.zeros(64, 64, dtype=bf).T
    assert dg.takes_kernel(x, [w]) and dg.takes_kernel(x, [w, w, w])
    assert dg.takes_kernel(x, [t]) and not dg.takes_kernel(x, [t, w])
    assert not dg.takes_kernel(x, [w, w, w, w])
    wide = torch.zeros(64, 72, dtype=bf)
    assert not dg.takes_kernel(x, [wide[:, 4:68]])       # 8 bytes off
    assert dg.takes_kernel(x, [wide[:, 8:]])
    assert dg.takes_kernel(x, [w[:, 8:]])                # a column view
    assert not dg.takes_kernel(x[..., :60], [w[:60]])    # K 60
    assert not dg.takes_kernel(x, [w.float()])
    assert not dg.takes_kernel(torch.zeros(17, 64, dtype=bf), [w])
    assert dg.takes_kernel(torch.zeros(16, 64, dtype=bf), [w])
    assert not dg.takes_kernel(x, [torch.zeros(32, 64, dtype=bf)])


@pytest.mark.parametrize("k,ns,transposed,split", [
    (3584, (14336, 256, 112), False, 2),  # zamba2-7b in-projection: 115 tiles
    (7168, (3584,), False, 8),            # w_out, wo: 28 tiles
    (14336, (3584,), False, 8),           # the MLP's down
    (7168, (7168,), False, 4),            # q, k, v: 56 tiles
    (3584, (14336,), False, 2),           # gate, up
    (3584, (3584,), False, 8),            # L_j
    (3584, (128,), False, 8),             # the adapter's A: one tile
    (128, (28672,), False, 1),            # its B: two stages of K
    (3584, (32000,), True, 1),            # the tied head: 500 tiles of 64
    (2560, (2560,), False, 8),            # danube's q, o: 20 tiles
    (2560, (640,), False, 8),             # its k, v
    (2560, (6912,), False, 4),            # gate, up: 54 tiles
    (6912, (2560,), False, 8),            # down
    (2560, (32000,), False, 1),           # the untied head: 250 tiles
    (256, (64,), False, 4),               # four stages of K: four blocks
])
def test_split_follows_the_shapes(k, ns, transposed, split):
    """At the kernel's tile (``TILE_N``: 128 columns, 64 of a transposed
    weight) on 132 SMs: the least split of K that gives every SM a
    block, up to a cluster of ``MAX_SPLIT`` and one stage a block."""
    tile = dg.TILE_N[transposed]
    assert dg.split_for(k, dg.tiles_of(ns, tile), 132, tile) == split


def test_wrapper_raises_off_the_cpu_and_the_card():
    meta = torch.empty(1, 1, 64, dtype=torch.bfloat16, device="meta")
    w = torch.empty(64, 64, dtype=torch.bfloat16, device="meta")
    n = counters.read()["decode_gemm"]
    with pytest.raises(ValueError, match="no kernel"):
        dg.decode_gemm(meta, [w])
    assert counters.read()["decode_gemm"] == n


@pytest.mark.parametrize("name,key,source", [
    ("TILE_N", False, "kTile"), ("TILE_N", True, "kTileT"),
    ("STAGE_ELEMS", None, "kWeightElems"), ("MAX_SPLIT", None, "kMaxSplit"),
    ("MAX_WEIGHTS", None, "kMaxSeg")])
def test_wrapper_constants_are_the_kernels(name, key, source):
    """The tile widths, stage size, cluster size and weight count the
    wrapper plans with are the constants ``csrc/decode_gemm.cu`` is
    built with."""
    cu = Path(dg.__file__).parents[1] / "csrc" / "decode_gemm.cu"
    found = re.search(rf"constexpr int {source} = (\d+);", cu.read_text())
    value = getattr(dg, name)
    assert found and (value if key is None else value[key]) \
        == int(found.group(1))
