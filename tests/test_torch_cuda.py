"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one.  They import
neither JAX nor the JAX package, so they also run where only PyTorch is
installed; from the root of a checkout:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)
Tolerances are the repo's: f32 2e-5, bf16 2e-2 (absolute and relative).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.add_rms_norm import ops as norm
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.decode_gemm import ops as dgemm
from repro_torch.kernels.glu_gate import ops as gate
from repro_torch.kernels.mamba2_conv_step import ops as conv_step
from repro_torch.kernels.mamba2_gate_norm import ops as gate_norm
from repro_torch.kernels.rope_kv_write import ops as rope
from repro_torch.kernels.rwkv6_scan import ops as wkv
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.swa_prefill import ops as pre
from repro_torch.utils import counters

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def as_np(x):
    return x.float().cpu().numpy()


def attention_launches(before):
    """The ``swa_prefill`` and ``decode_attention`` launches since the
    counts ``before`` (``counters.read()``)."""
    now = counters.read()
    return tuple(now[k] - before[k] for k in ("swa_prefill",
                                               "decode_attention"))


# the reference's SSD bf16 tolerance (tests/test_kernels.py), which the
# chunked form is held to against the recurrence
SSD_BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def ssd_inputs(b, t, h, p, n, dtype, dev, seed=0):
    """x, B, C in ``dtype``; dt after a softplus and a_log scaled 0.3, as
    the reference's kernel tests draw them; h0 in f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, t, h, generator=g, device=dev))
    a_log = torch.randn(h, generator=g, device=dev) * 0.3
    bm, cm = (torch.randn(b, t, n, generator=g, device=dev).to(dtype)
              for _ in range(2))
    h0 = torch.randn(b, h, p, n, generator=g, device=dev) * 0.1
    return x, dt, a_log, bm, cm, h0


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,w", [(1, 256, 9, 3, 64, 256),
                                          (4, 200, 9, 3, 64, 64),
                                          (2, 77, 4, 1, 128, 1000),
                                          (4, 256, 32, 32, 80, 4096),
                                          (2, 77, 4, 4, 80, 16),
                                          (4, 256, 8, 1, 256, 256),
                                          (2, 77, 8, 1, 256, 16),
                                          (4, 320, 12, 2, 128, 320),
                                          (4, 256, 64, 8, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_prefill_kernel_matches_plain_on_card(b, s, h, kv, d, w, dtype,
                                                  cuda_device):
    tdt = DTYPES[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device=cuda_device).to(tdt)
    k = torch.randn(b, s, kv, d, generator=g, device=cuda_device).to(tdt)
    v = torch.randn(b, s, kv, d, generator=g, device=cuda_device).to(tdt)
    before = counters.read()["swa_prefill"]
    out = pre.swa_prefill_attention(q, k, v, window=w)
    torch.cuda.synchronize()
    assert counters.read()["swa_prefill"] == before + 1
    ref = pre.swa_prefill_plain(q, k, v, window=w)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,kv,g,d,s,lens", [(4, 3, 3, 64, 321, [0, 1, 160, 321]),
                                             (2, 2, 8, 128, 77, [5, 77]),
                                             (4, 32, 1, 80, 321, [1, 160, 320, 321]),
                                             (2, 4, 1, 80, 16, [16, 9]),
                                             (4, 1, 8, 256, 321, [0, 1, 160, 321]),
                                             (4, 2, 6, 128, 352, [1, 100, 321, 352]),
                                             (4, 8, 8, 128, 321, [1, 100, 257, 321]),
                                             (4, 20, 1, 64, 1500, [1500] * 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_on_card(b, kv, g, d, s, lens,
                                                       dtype, cuda_device):
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(b, kv, g, d, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(b, s, kv, d, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(b, s, kv, d, generator=gen, device=cuda_device).to(tdt)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = counters.read()["decode_attention"]
    out = dec.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert counters.read()["decode_attention"] == before + 1
    ref = dec.decode_attention_plain(q, k, v, ln)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))


# bf16 runs the tensor-core prefill (64-row query tiles of 4 warps x 16
# rows, 64-key tiles) and the cluster-split decode (up to 8 blocks per
# (batch row, KV head), each reading its range of the valid rows): these
# cases sit on the edges of those tilings
@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 15, 63, 65, 200])
@pytest.mark.parametrize("w", [1, 17, 64, 4096])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("g", [1, 3, 8])
def test_swa_prefill_bf16_tiling_edges_on_card(s, w, d, g, cuda_device):
    b, kv = 2, 2
    gen = torch.Generator(device=cuda_device).manual_seed(s * 7 + d)
    q = torch.randn(b, s, kv * g, d, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    v = torch.randn(b, s, kv, d, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    before = counters.read()["swa_prefill"]
    out = pre.swa_prefill_attention(q, k, v, window=w)
    torch.cuda.synchronize()
    assert counters.read()["swa_prefill"] == before + 1
    ref = pre.swa_prefill_plain(q, k, v, window=w)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 16, 321, 4096])
@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_decode_attention_bf16_split_edges_on_card(s, g, d, cuda_device):
    """Lengths 0 (the mean of V over all S rows), 1 (one block of the
    cluster holds a row, the others none), S, and one whose rows split
    unevenly over the cluster's blocks."""
    b, kv = 4, 2
    lens = [0, 1, s, s * 3 // 5 + 1]
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + g)
    q = torch.randn(b, kv, g, d, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    v = torch.randn(b, s, kv, d, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = counters.read()["decode_attention"]
    out = dec.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert counters.read()["decode_attention"] == before + 1
    ref = dec.decode_attention_plain(q, k, v, ln)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol("bfloat16"))


def assert_lse_close(lse, ref, dtype):
    """Log-sum-exps within the tolerance where the row has a valid
    position; a row of length 0 (every score -1e30) at or below -1e29
    on both sides (its weight in a merge is 0 either way)."""
    empty = ref <= -1e29
    assert torch.equal(lse <= -1e29, empty)
    np.testing.assert_allclose(as_np(lse[~empty]), as_np(ref[~empty]),
                               **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,kv,g,d,s,lens", [(4, 3, 3, 64, 320, [0, 1, 160, 320]),
                                             (4, 32, 1, 80, 321, [1, 160, 320, 321]),
                                             (2, 8, 4, 80, 16, [16, 9]),
                                             (4, 1, 8, 256, 320, [0, 1, 33, 320]),
                                             (4, 2, 6, 128, 352, [1, 100, 321, 352])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_lse_and_its_merge_on_card(b, kv, g, d, s, lens,
                                                    dtype, cuda_device):
    """The kernel's (out, lse) against the plain version's; the calls
    over 2 and 4 row ranges (local lengths clamped to each range)
    merged by their lse against the whole-cache call."""
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q = torch.randn(b, kv, g, d, generator=gen, device=cuda_device).to(tdt)
    k = torch.randn(b, s, kv, d, generator=gen, device=cuda_device).to(tdt)
    v = torch.randn(b, s, kv, d, generator=gen, device=cuda_device).to(tdt)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = counters.read()["decode_attention"]
    out, lse = dec.decode_attention(q, k, v, ln, return_lse=True)
    torch.cuda.synchronize()
    assert counters.read()["decode_attention"] == before + 1
    ref, ref_lse = dec.decode_attention_plain(q, k, v, ln, return_lse=True)
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol(dtype))
    assert_lse_close(lse, ref_lse, dtype)
    keep = ln > 0                  # a merge needs a valid row somewhere
    for n_parts in (2, 4):
        n_local = s // n_parts
        parts = []
        for r in range(n_parts):
            rows = slice(r * n_local, (r + 1) * n_local)
            local = torch.clamp(ln - r * n_local, 0, n_local).to(torch.int32)
            parts.append(dec.decode_attention(
                q, k[:, rows].contiguous(), v[:, rows].contiguous(), local,
                return_lse=True))
        whole = dec.decode_attention(q, k[:, :n_parts * n_local].contiguous(),
                                     v[:, :n_parts * n_local].contiguous(),
                                     torch.clamp(ln, max=n_parts * n_local))
        merged = dec.merge_by_lse(parts)
        np.testing.assert_allclose(as_np(merged[keep]), as_np(whole[keep]),
                                   **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,d", [(4, 256, 32, 64), (4, 1, 32, 64),
                                     (2, 77, 3, 32), (1, 300, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_kernel_matches_plain_on_card(b, t, h, d, dtype,
                                                 cuda_device):
    """r/k/v in ``dtype``, the decay w in f32 (as the model feeds it);
    y and the final state against the plain version, then the same call
    with the state updated in place."""
    tdt = DTYPES[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    r, k, v = (torch.randn(b, t, h, d, generator=g, device=cuda_device)
               .mul(0.5).to(tdt) for _ in range(3))
    w = torch.rand(b, t, h, d, generator=g, device=cuda_device) * 0.199 + 0.8
    u = torch.randn(h, d, generator=g, device=cuda_device) * 0.5
    s0 = torch.randn(b, h, d, d, generator=g, device=cuda_device) * 0.1
    before = counters.read()["rwkv6_scan"]
    y, s = wkv.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert counters.read()["rwkv6_scan"] == before + 1
    y_ref, s_ref = wkv.rwkv6_scan_plain(r, k, v, w, u, s0)
    np.testing.assert_allclose(as_np(y), as_np(y_ref), **tol(dtype))
    np.testing.assert_allclose(as_np(s), as_np(s_ref), **tol(dtype))
    state = s0.clone()
    y2, s2 = wkv.rwkv6_scan(r, k, v, w, u, state, s_out=state)
    torch.cuda.synchronize()
    assert s2 is state
    assert torch.equal(y2, y) and torch.equal(state, s)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 17, 300])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_scan_is_bit_exact_on_card(t, d, dtype, cuda_device):
    """Four threads per state column take the plain version's rounded
    steps in its order (the last two levels of the pairwise tree as xor
    shuffles): y and the final state equal it bit for bit."""
    tdt = DTYPES[dtype]
    b, h = 2, 3
    g = torch.Generator(device=cuda_device).manual_seed(t * 3 + d)
    r, k, v = (torch.randn(b, t, h, d, generator=g, device=cuda_device)
               .mul(0.5).to(tdt) for _ in range(3))
    w = torch.rand(b, t, h, d, generator=g, device=cuda_device) * 0.199 + 0.8
    u = torch.randn(h, d, generator=g, device=cuda_device) * 0.5
    s0 = torch.randn(b, h, d, d, generator=g, device=cuda_device) * 0.1
    y, s = wkv.rwkv6_scan(r, k, v, w, u, s0)
    y_ref, s_ref = wkv.rwkv6_scan_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,p,n", [(4, 256, 80, 64, 64), (4, 1, 80, 64, 64),
                                       (2, 77, 3, 32, 16), (1, 300, 2, 32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bfloat16-y32"])
def test_ssd_scan_kernel_matches_plain_on_card(b, t, h, p, n, dtype,
                                               cuda_device):
    """x, B, C in ``dtype``, dt after a softplus in f32; ``bfloat16-y32``
    is a decode step's case (bf16 inputs, y in f32).  y and the final
    state against the plain version (the recurrence), then the same call
    with the state updated in place.  Where the kernel runs the chunked
    form (bf16, T >= CHUNKED_MIN_T) both are held to the reference's SSD
    bf16 tolerance (5e-2, ``tests/test_kernels.py``), as the Pallas
    kernel is; the recurrence to the repo's f32 and bf16 tolerances."""
    tdt = DTYPES[dtype[:8] if dtype != "float32" else dtype]
    y_dtype = torch.float32 if dtype == "bfloat16-y32" else tdt
    x, dt, a_log, bm, cm, h0 = ssd_inputs(b, t, h, p, n, tdt, cuda_device)
    before = counters.read()["ssd_scan"]
    y, hf = ssd.ssd_scan(x, dt, a_log, bm, cm, h0, y_dtype=y_dtype)
    torch.cuda.synchronize()
    assert counters.read()["ssd_scan"] == before + 1 and y.dtype == y_dtype
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt, a_log, bm, cm, h0,
                                      y_dtype=y_dtype)
    if ssd.takes_chunked_form(x):
        np.testing.assert_allclose(as_np(y), as_np(y_ref), **SSD_BF16_TOL)
        np.testing.assert_allclose(as_np(hf), as_np(h_ref), **SSD_BF16_TOL)
    else:
        name = "float32" if y_dtype == torch.float32 else "bfloat16"
        np.testing.assert_allclose(as_np(y), as_np(y_ref), **tol(name))
        np.testing.assert_allclose(as_np(hf), as_np(h_ref), **tol("float32"))
    state = h0.clone()
    y2, h2 = ssd.ssd_scan(x, dt, a_log, bm, cm, state, h_out=state,
                          y_dtype=y_dtype)
    torch.cuda.synchronize()
    assert h2 is state
    assert torch.equal(y2, y) and torch.equal(state, hf)


# bf16 around the chunked form's threshold and its 64-step chunks
@pytest.mark.cuda
@pytest.mark.parametrize("t", [ssd.CHUNKED_MIN_T - 1, ssd.CHUNKED_MIN_T, 63,
                               64, 65, 77, 256, 300])
@pytest.mark.parametrize("p,n", [(32, 16), (32, 64), (64, 16), (64, 64)])
@pytest.mark.parametrize("y32", [False, True])
def test_ssd_scan_bf16_chunked_edges_on_card(t, p, n, y32, cuda_device):
    """The chunked form against ``ssd_scan_chunked_plain`` (y 2e-2, the
    final state 2e-4) and against the recurrence (5e-2); below the
    threshold the recurrence against its plain version as before."""
    b, h = 2, 3
    y_dtype = torch.float32 if y32 else torch.bfloat16
    x, dt, a_log, bm, cm, h0 = ssd_inputs(b, t, h, p, n, torch.bfloat16,
                                          cuda_device, seed=t + p + n)
    y, hf = ssd.ssd_scan(x, dt, a_log, bm, cm, h0, y_dtype=y_dtype)
    torch.cuda.synchronize()
    y_rec, h_rec = ssd.ssd_scan_plain(x, dt, a_log, bm, cm, h0,
                                      y_dtype=y_dtype)
    assert torch.isfinite(y.float()).all() and torch.isfinite(hf).all()
    if t < ssd.CHUNKED_MIN_T:
        np.testing.assert_allclose(as_np(y), as_np(y_rec),
                                   **tol("float32" if y32 else "bfloat16"))
        np.testing.assert_allclose(as_np(hf), as_np(h_rec), **tol("float32"))
        return
    y_ch, h_ch = ssd.ssd_scan_chunked_plain(x, dt, a_log, bm, cm, h0,
                                            y_dtype=y_dtype)
    np.testing.assert_allclose(as_np(y), as_np(y_ch), **tol("bfloat16"))
    np.testing.assert_allclose(as_np(hf), as_np(h_ch), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(as_np(y), as_np(y_rec), **SSD_BF16_TOL)
    np.testing.assert_allclose(as_np(hf), as_np(h_rec), **SSD_BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [32, 77, 256, 300])
def test_ssd_scan_bf16_state_continuation_on_card(t, cuda_device):
    """[0:T] against [0:T/2] then [T/2:T] with the carried state updated
    in place (a chunked prefill's state feeding what follows), bf16 at
    the reference's SSD bf16 tolerance; then T/2 recurrence decode steps
    after the chunked half against the recurrence throughout."""
    b, h, p, n = 2, 3, 64, 64
    x, dt, a_log, bm, cm, h0 = ssd_inputs(b, t, h, p, n, torch.bfloat16,
                                          cuda_device, seed=t)
    y_full, h_full = ssd.ssd_scan(x, dt, a_log, bm, cm, h0)
    m = t // 2
    first = [a[:, :m].contiguous() for a in (x, dt, bm, cm)]
    second = [a[:, m:].contiguous() for a in (x, dt, bm, cm)]
    y1, h1 = ssd.ssd_scan(first[0], first[1], a_log, first[2], first[3], h0)
    y2, h2 = ssd.ssd_scan(second[0], second[1], a_log, second[2], second[3],
                          h1, h_out=h1)
    torch.cuda.synchronize()
    assert h2 is h1
    np.testing.assert_allclose(as_np(torch.cat([y1, y2], 1)), as_np(y_full),
                               **SSD_BF16_TOL)
    np.testing.assert_allclose(as_np(h2), as_np(h_full), **SSD_BF16_TOL)
    # the chunked half, then decode steps (T 1, y in f32) in place
    _, state = ssd.ssd_scan(first[0], first[1], a_log, first[2], first[3], h0)
    ys = [ssd.ssd_scan(*(a[:, i:i + 1].contiguous() for a in second[:2]),
                       a_log, *(a[:, i:i + 1].contiguous() for a in second[2:]),
                       state, h_out=state, y_dtype=torch.float32)[0]
          for i in range(t - m)]
    y_ref, h_ref = ssd.ssd_scan_plain(x, dt, a_log, bm, cm, h0,
                                      y_dtype=torch.float32)
    np.testing.assert_allclose(as_np(torch.cat(ys, 1)), as_np(y_ref[:, m:]),
                               **SSD_BF16_TOL)
    np.testing.assert_allclose(as_np(state), as_np(h_ref), **SSD_BF16_TOL)


# --------------------------------------------------------------------------
# on the card: h2o-danube-1.8b's sliding window past its end
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_ring_wrap_on_card(dtype, cuda_device):
    """h2o-danube-1.8b at full width cut to 2 layers: a 4160-token prompt
    past the 4096-token window (``swa_prefill`` skips the tiles outside
    the band, the prefill wraps the ring), then 8 decode steps over the
    wrapped ring, fed the plain route's greedy ids.  The kernel route
    matches the plain route: f32 logits within 1e-3 and the same greedy
    ids; bf16 logits within 2e-2 of the plain route's, relative to
    their largest magnitude."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("h2o-danube-1.8b")
    cfg = dataclasses.replace(cfg, num_layers=2, blocks=cfg.blocks[:2],
                              dtype=dtype, param_dtype=dtype)
    kern = build_model(dataclasses.replace(cfg, use_pallas_prefill=True,
                                           use_pallas_decode=True),
                       device=cuda_device)
    plain = build_model(cfg, device=cuda_device)
    params = kern.init(kern.generator(0))
    s, steps, vocab = 4160, 8, cfg.vocab_size
    g = torch.Generator(device=cuda_device).manual_seed(1)
    tokens = torch.randint(0, vocab, (1, s), generator=g, device=cuda_device,
                           dtype=torch.int32)
    before = counters.read()
    with torch.inference_mode():
        lk, ck = kern.prefill(params, {"tokens": tokens}, cache_len=s + 9)
        lp, cp = plain.prefill(params, {"tokens": tokens}, cache_len=s + 9)
        assert ck["k"].shape[2] == cfg.window_size == 4096
        got, ref = [lk.float()], [lp.float()]
        for _ in range(steps):
            tok = lp[:, :vocab].argmax(-1).to(torch.int32)[:, None]
            lk, ck = kern.decode_step(params, ck, tok)
            lp, cp = plain.decode_step(params, cp, tok)
            got.append(lk.float())
            ref.append(lp.float())
    torch.cuda.synchronize()
    assert attention_launches(before) == \
        (2, 2 * steps)
    got, ref = torch.stack(got), torch.stack(ref)
    assert torch.isfinite(got).all()
    if dtype == "float32":
        assert float((got - ref).abs().max()) <= 1e-3
        assert torch.equal(got[..., :vocab].argmax(-1),
                           ref[..., :vocab].argmax(-1))
    else:
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 2e-2 * scale


# --------------------------------------------------------------------------
# on the card: the decode step's fused kernels (bf16 only)
# --------------------------------------------------------------------------
FUSED_TOL = dict(atol=1e-2, rtol=1e-2)


def bf16_randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device=gen.device)
            * scale).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("d", [576, 960, 2048, 2560, 7168])
@pytest.mark.parametrize("with_y", [True, False])
def test_add_rms_norm_kernel_matches_plain_on_card(rows, d, with_y,
                                                   cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x, y = bf16_randn(gen, rows, 1, d), bf16_randn(gen, rows, 1, d)
    scale = bf16_randn(gen, d, scale=0.1)
    y = y if with_y else None
    before = counters.read()["add_rms_norm"]
    x_new, h = norm.add_rms_norm(x, y, scale, 1e-5)
    torch.cuda.synchronize()
    assert counters.read()["add_rms_norm"] == before + 1
    ref_x, ref_h = norm.add_rms_norm_plain(x, y, scale, 1e-5)
    assert torch.equal(x_new, ref_x)
    np.testing.assert_allclose(as_np(h), as_np(ref_h), **FUSED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("ff", [1536, 6912, 16384])
@pytest.mark.parametrize("kind", ["swiglu", "geglu"])
def test_glu_gate_kernel_matches_plain_on_card(rows, ff, kind, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    g, u = bf16_randn(gen, rows, 1, ff, scale=3.0), bf16_randn(gen, rows, 1, ff)
    before = counters.read()["glu_gate"]
    out = gate.glu_gate(g, u, kind)
    torch.cuda.synchronize()
    assert counters.read()["glu_gate"] == before + 1
    np.testing.assert_allclose(as_np(out), as_np(gate.glu_gate_plain(g, u, kind)),
                               **FUSED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,d", [(1, 32, 8, 80), (16, 32, 8, 80),
                                      (8, 9, 3, 64), (4, 8, 1, 256),
                                      (4, 32, 32, 80)])
@pytest.mark.parametrize("window,s,index", [(16, 16, 5), (16, 16, 16),
                                            (16, 16, 4100), (0, 32, 5),
                                            (0, 32, 31)])
def test_rope_kv_write_kernel_matches_plain_on_card(b, h, kv, d, window, s,
                                                    index, cuda_device):
    """q and the K row within the bf16 tolerance, the V row exactly, each
    in its slot (a ring buffer before and past its wrap, a full cache up
    to its last slot) and no other slot touched."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (bf16_randn(gen, b, 1, n, d) for n in (h, kv, kv))
    ck0, cv0 = bf16_randn(gen, b, s, kv, d), bf16_randn(gen, b, s, kv, d)
    idx = torch.tensor(index, dtype=torch.int32, device=cuda_device)
    ck, cv, pk, pv = (t.clone() for t in (ck0, cv0, ck0, cv0))
    before = counters.read()["rope_kv_write"]
    out = rope.rope_kv_write(q, k, v, idx, ck, cv, 1e4, window)
    torch.cuda.synchronize()
    assert counters.read()["rope_kv_write"] == before + 1
    ref = rope.rope_kv_write_plain(q, k, v, idx, pk, pv, 1e4, window)
    assert out.shape == (b, kv, h // kv, d)
    np.testing.assert_allclose(as_np(out), as_np(ref), **FUSED_TOL)
    slot = index % s if window else index
    rest = torch.arange(s, device=cuda_device) != slot
    assert torch.equal(cv, pv)
    assert torch.equal(ck[:, rest], ck0[:, rest])
    np.testing.assert_allclose(as_np(ck[:, slot]), as_np(pk[:, slot]),
                               **FUSED_TOL)


@pytest.mark.cuda
def test_fused_kernels_refuse_f32_on_card(cuda_device):
    """A CUDA tensor never falls back to the plain version."""
    x = torch.zeros(2, 1, 64, device=cuda_device)
    idx = torch.zeros((), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        norm.add_rms_norm(x, None, torch.zeros(64, device=cuda_device), 1e-5)
    with pytest.raises(ValueError, match="bfloat16"):
        gate.glu_gate(x, x, "swiglu")
    q = torch.zeros(2, 1, 4, 16, device=cuda_device)
    c = torch.zeros(2, 8, 4, 16, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        rope.rope_kv_write(q, q, q, idx, c, c, 1e4, 0)


@pytest.mark.cuda
def test_bf16_decode_replay_counts_the_fused_kernels_on_card(cuda_device):
    """h2o-danube-1.8b's stack cut to 2 layers in bf16: the captured
    decode entry holds 2 L + 1 ``add_rms_norm``, L ``rope_kv_write``,
    L ``glu_gate``, L ``decode_attention`` and 7 L + 1 ``decode_gemm``
    (q, k, v, o, gate, up, down and the head) launches, every replay adds
    them, and its ids equal the eager entry's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import token_backend as tb
    from repro_torch.serving.capture import launch_counts

    cfg = get_config("h2o-danube-1.8b")
    cfg = dataclasses.replace(cfg, num_layers=2, blocks=cfg.blocks[:2],
                              use_pallas_prefill=True, use_pallas_decode=True)
    model = build_model(cfg, device=cuda_device)
    params = model.init(model.generator(0))
    layers, b, pl, steps = 2, 4, 32, 6
    want = {"decode_attention": layers, "add_rms_norm": 2 * layers + 1,
            "rope_kv_write": layers, "glu_gate": layers,
            "decode_gemm": 7 * layers + 1}
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, pl)).astype(np.int32)
    ids = {}
    for capture in (True, False):
        pre_fns, dec_fns = tb.build_token_step_fns(
            model, params, (1,), (b,), pl, max_decode=steps, capture=capture)
        tb.warmup_token_fns(pre_fns, dec_fns, pl)
        if capture:
            assert dec_fns[(1, b)].step.deltas == want
            before = launch_counts()
        tok, cache = pre_fns[(1, b)](prompt)
        out = [tok.clone()]
        for _ in range(steps):
            tok, cache = dec_fns[(1, b)](cache, tok)
            out.append(tok.clone())
        torch.cuda.synchronize()
        if capture:
            after = launch_counts()
            assert {k: after[k] - before[k] for k in want} == \
                {k: n * steps for k, n in want.items()}
        ids[capture] = torch.stack(out)
    assert torch.equal(ids[True], ids[False])


# --------------------------------------------------------------------------
# on the card: the fixed-work table entry (prefill + greedy decode steps)
# --------------------------------------------------------------------------
GEN_TOKENS = 8


@pytest.fixture(scope="module")
def fixed_routes():
    """Per arch: the f32 kernel-route and plain-route models of smollm-135m
    (full width and the reduced cut) on one set of random weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    out = {}
    for arch in ("smollm-135m", "smollm-135m-reduced"):
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  param_dtype="float32")
        kcfg = dataclasses.replace(cfg, use_pallas_prefill=True,
                                   use_pallas_decode=True)
        kern = build_model(kcfg, device=dev)
        out[arch] = (kern, build_model(cfg, device=dev),
                     kern.init(kern.generator(0)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "smollm-135m-reduced"])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("prompt", [16, 64])
def test_fixed_work_entry_on_card(arch, b, prompt, fixed_routes):
    """Kernel-route ids (the captured entry, replayed) equal plain-route
    ids (eager) in f32, and the entry reads nothing back to the host
    between its first launch and its return.  The first call captures
    the entry; the launches are counted over the replay after it."""
    from repro_torch.serving.api import build_llm_step_fns

    kern, plain, params = fixed_routes[arch]
    dev = kern.device
    g = torch.Generator(device=dev).manual_seed(b * 100 + prompt)
    tokens = torch.randint(0, kern.cfg.vocab_size, (b, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    fk = build_llm_step_fns(kern, params, (1,), (b,), prompt,
                            GEN_TOKENS)[(1, b)]
    fp = build_llm_step_fns(plain, params, (1,), (b,), prompt,
                            GEN_TOKENS, capture=False)[(1, b)]
    fk(torch.zeros_like(tokens))                 # capture
    assert fk.step.graph is not None and fp.step.graph is None
    before = counters.read()
    ids_k, ids_p = fk(tokens), fp(tokens)
    torch.cuda.synchronize()
    layers = kern.cfg.num_layers
    assert attention_launches(before) == \
        (layers, layers * GEN_TOKENS)
    assert ids_k.dtype == torch.int32 and ids_k.shape == (b, GEN_TOKENS)
    assert torch.equal(ids_k, ids_p)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fk(tokens)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, ids_k)


# --------------------------------------------------------------------------
# on the card: the step tables captured as CUDA graphs
# --------------------------------------------------------------------------
CAPTURE_ARCHS = ("smollm-135m-reduced", "rwkv6-1.6b-reduced",
                 "zamba2-2.7b-reduced", "gemma-2b-reduced",
                 "h2o-danube-1.8b-reduced", "kimi-k2-1t-a32b-reduced",
                 "deepseek-v3-671b-reduced")


@pytest.fixture(scope="module")
def reduced_models():
    """Per arch: the f32 reduced model with both kernel routes on and
    its random weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    out = {}
    for arch in CAPTURE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                  param_dtype="float32",
                                  use_pallas_prefill=True,
                                  use_pallas_decode=True)
        model = build_model(cfg, device=dev)
        out[arch] = (model, model.init(model.generator(0)))
    return out


def _logit_steps(model, params, b, prompt_len, steps, capture):
    """A prefill and a decode step over one static gang, each returning
    its logits and writing its greedy ids into the gang's id buffer."""
    from repro_torch.serving.capture import CapturedStep

    vocab, dev = model.cfg.vocab_size, model.device
    with torch.inference_mode():
        cache = model.init_cache(b, prompt_len + steps + 1)
        tokens = torch.zeros((b, prompt_len), dtype=torch.int32, device=dev)
        ids = torch.zeros((b,), dtype=torch.int32, device=dev)

    def prefill():
        lg, _ = model.prefill(params, {"tokens": tokens}, cache=cache)
        ids.copy_(lg[:, :vocab].argmax(-1))
        return lg

    def decode():
        lg, _ = model.decode_step(params, cache, ids[:, None])
        ids.copy_(lg[:, :vocab].argmax(-1))
        return lg

    return (CapturedStep(prefill, (tokens,), capture),
            CapturedStep(decode, (ids,), capture), ids)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_replay_equals_eager_on_card(arch, reduced_models):
    """Graph replay gives the eager step's logits (f32 tolerance) and ids
    (exact) for two prompts in turn, which shows that the static inputs
    are refreshed, and a replay reads nothing back to the host.  The
    captured steps are warmed (captured) first on a prompt of zeros."""
    model, params = reduced_models[arch]
    dev = model.device
    b, pl, steps = 3, 16, 5
    routes = [_logit_steps(model, params, b, pl, steps, capture)
              for capture in (True, False)]
    pre_step, dec_step, ids = routes[0]
    pre_step(torch.zeros((b, pl), dtype=torch.int32, device=dev))
    dec_step(ids)
    assert pre_step.replays == dec_step.replays == 0
    for seed in (0, 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.randint(0, model.cfg.vocab_size, (b, pl), generator=g,
                             device=dev, dtype=torch.int32)
        outs = []
        for pre_r, dec_r, ids_r in routes:
            logits, got = [pre_r(toks).clone()], [ids_r.clone()]
            for _ in range(steps):
                logits.append(dec_r(ids_r).clone())
                got.append(ids_r.clone())
            outs.append((torch.stack(logits), torch.stack(got)))
        (lc, ic), (le, ie) = outs
        assert torch.equal(ic, ie), seed
        np.testing.assert_allclose(as_np(lc), as_np(le), **tol("float32"))
    assert pre_step.graph is not None and dec_step.graph is not None
    assert (pre_step.replays, dec_step.replays) == (2, 2 * steps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pre_step(toks)
        for _ in range(steps):
            dec_step(ids)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(ids, ic[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_replays_count_their_launches_on_card(arch, reduced_models):
    """Each captured entry records the launches its graph holds, and every
    replay adds exactly those to the kernels' counts."""
    from repro_torch.serving import token_backend as tb
    from repro_torch.serving.capture import launch_counts

    model, params = reduced_models[arch]
    cfg = model.cfg
    b, pl, steps = 2, 8, 3
    pre_fns, dec_fns = tb.build_token_step_fns(model, params, (1, 2), (b,),
                                               pl, max_decode=steps)
    tb.warmup_token_fns(pre_fns, dec_fns, pl)
    layers = cfg.num_layers
    if cfg.blocks[0] == "rwkv6+rwkv_cm":
        want_pre = want_dec = {"rwkv6_scan": layers}
    elif cfg.blocks[0] == "mamba2+none":
        apps = -(-layers // cfg.shared_attn_every)
        want_pre = {"ssd_scan": layers, "swa_prefill": apps}
        want_dec = {"ssd_scan": layers, "decode_attention": apps}
    elif "mla" in cfg.mixer_kinds:      # MLA and the experts: plain PyTorch
        want_pre = want_dec = {}
    else:
        want_pre, want_dec = ({"swa_prefill": layers},
                              {"decode_attention": layers})
    pre_step, dec_step = pre_fns[(1, b)].step, dec_fns[(1, b)].step
    assert pre_step.deltas == want_pre and dec_step.deltas == want_dec
    before = launch_counts()
    tok, cache = pre_fns[(2, b)](np.ones((b, pl), np.int32))
    for _ in range(steps):
        tok, cache = dec_fns[(2, b)](cache, tok)
    torch.cuda.synchronize()
    after = launch_counts()
    for name in after:
        assert after[name] - before[name] == \
            want_pre.get(name, 0) + steps * want_dec.get(name, 0), name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CAPTURE_ARCHS)
def test_fixed_work_replay_equals_eager_on_card(arch, reduced_models):
    """The fixed-work entry as one graph (prefill, decode steps, argmaxes
    and id stack), captured by a first call on a prompt of zeros, gives
    the eager entry's ids for two prompts in turn, each returned as a
    copy that the next replay leaves alone."""
    from repro_torch.serving.api import build_llm_step_fns

    model, params = reduced_models[arch]
    dev = model.device
    b, pl = 4, 16
    cap = build_llm_step_fns(model, params, (1,), (b,), pl, GEN_TOKENS)[(1, b)]
    eag = build_llm_step_fns(model, params, (1,), (b,), pl, GEN_TOKENS,
                             capture=False)[(1, b)]
    cap(np.zeros((b, pl), np.int32))
    kept, wants = [], []
    for seed in (0, 1):
        g = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.randint(0, model.cfg.vocab_size, (b, pl), generator=g,
                             device=dev, dtype=torch.int32)
        kept.append(cap(toks))
        wants.append(eag(toks))
    for got, want in zip(kept, wants):
        assert got.shape == (b, GEN_TOKENS) and torch.equal(got, want)
    assert cap.step.graph is not None and cap.step.replays == 2


# --------------------------------------------------------------------------
# on the card: the session scenarios on the live fixed-work server
# --------------------------------------------------------------------------
SESSION_SETS = dict(c_set=(1, 2, 4, 8), b_set=(1, 2, 4, 8))


@pytest.fixture(scope="module")
def live_fixed_table():
    """The reduced smollm's fixed-work table on the card (captured at
    warm-up) and the l(b, c) make_live_server fitted from it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from repro_torch.serving.api import make_live_server

    server, cfg = make_live_server("smollm-135m-reduced", prompt_len=16,
                                   gen_tokens=GEN_TOKENS, seed=0,
                                   device=torch.device("cuda", 0),
                                   **SESSION_SETS)
    return server.backend.step_fns, server.backend.perf, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("mid_flight", [True, False])
@pytest.mark.parametrize("name", ["slo-renegotiation", "cancel-storm"])
def test_live_session_modelled_clock_equals_exact_engine_on_card(
        name, mid_flight, live_fixed_table):
    """A session on the live server (``TorchBackend`` over the captured
    table, modelled clock), fed the scenario's rows with prompts and its
    update/cancel stream, makes the decisions, buckets and applied counts
    of ``run_scenario(engine="exact")`` on ``SimBackend`` over the same
    fitted l(b, c), neither charging a resize penalty; every dispatch
    replays one entry (one ``swa_prefill`` per layer, one
    ``decode_attention`` per layer per step)."""
    from repro_torch.serving.api import (SpongeServer, TorchBackend,
                                         make_policy, pad_tokens)
    from repro_torch.serving.scenarios import build_scenario, run_scenario
    from repro_torch.serving.session import drive_session_events

    fns, perf, cfg = live_fixed_table
    batch, meta = build_scenario(name, requests=80, seed=0)
    policy = make_policy("sponge", perf, adaptation_interval=meta["tick"],
                         slo=meta["slo"], expected_rps=meta["expected_rps"],
                         **SESSION_SETS)
    backend = TorchBackend(fns, pad_tokens, perf, clock="modeled")
    server = SpongeServer(policy, backend, tick=meta["tick"],
                          prior_rps=meta["expected_rps"])
    sess = server.session()
    rng = np.random.default_rng(0)
    before = counters.read()
    handles = [sess.submit(r, payload=rng.integers(
        0, cfg.vocab_size, 16).astype(np.int32)) for r in batch.to_requests()]
    applied = drive_session_events(
        sess, handles, meta["session_events"] if mid_flight else ())
    rep = sess.finish()
    torch.cuda.synchronize()
    ref, stats = run_scenario(name, engine="exact", perf=perf, requests=80,
                              seed=0, c0=8,
                              mid_flight=mid_flight, resize_penalty=0.0,
                              **SESSION_SETS)

    def stream(report):
        return [(t, d.c, d.b, d.feasible) for t, d in report.decisions]

    assert stream(rep) == stream(ref) and rep.decisions
    assert rep.buckets == ref.buckets
    assert (rep.n_requests, rep.violation_rate, rep.n_cancelled) == \
        (ref.n_requests, ref.violation_rate, ref.n_cancelled)
    assert applied == stats["session"]
    entries, layers = len(backend.measured), cfg.num_layers
    assert entries == len(rep.buckets) > 0
    assert attention_launches(before) == \
        (layers * entries, layers * GEN_TOKENS * entries)
    ids = np.stack([it.result for it in backend.results])
    assert ids.shape == (rep.n_requests, GEN_TOKENS)
    assert ((ids >= 0) & (ids < cfg.vocab_size)).all()


# --------------------------------------------------------------------------
# the decode-stream scan engine: captured chunks against the plain version
# --------------------------------------------------------------------------
def _scan_workload(duration, seed):
    from repro_torch.serving.scenarios import build_scenario
    batch, meta = build_scenario("llm-chat", duration=duration, seed=seed)
    return batch, meta["cost"]


def _scan_parity(a, b):
    assert a["decisions"] == b["decisions"]
    for k in ("first_tok", "finish"):
        assert np.array_equal(a[k], b[k], equal_nan=True), k
    assert np.array_equal(a["tbt_violations"], b["tbt_violations"])
    for k in ("core_seconds", "steps", "n_served"):
        assert a[k] == b[k], k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chunk16", "chunk64", "decide",
                                  "allowance"])
def test_scan_engine_on_card_matches_numpy(case, cuda_device):
    """``backend="torch"`` on the card (each chunk a replay of the graph
    captured at its first call) is bit for bit the NumPy plain version:
    static knobs at both chunk sizes, ``make_sponge_decide`` moving the
    knobs between chunks, and a prefill allowance that bites."""
    from repro_torch.core.scaler import SpongeScaler
    from repro_torch.core.solver import DEFAULT_B, DEFAULT_C
    from repro_torch.serving.scanpath import (ScanDecodeEngine,
                                              make_sponge_decide)
    batch, cost = _scan_workload(40, 3)
    kw = dict(c0=8, b0=8, chunk_steps=64)
    if case == "chunk16":
        kw["chunk_steps"] = 16
    elif case == "decide":
        kw = dict(c0=4, b0=4, chunk_steps=32, decide=make_sponge_decide(
            SpongeScaler(cost), cost, DEFAULT_C, DEFAULT_B))
    elif case == "allowance":
        kw = dict(c0=8, b0=16, chunk_steps=32, prefill_allowance=int(
            np.asarray(batch.prompt_tokens).mean() * 2))
    eng = ScanDecodeEngine(cost, **kw)
    out = eng.run(batch, backend="torch", device=cuda_device)
    ref = ScanDecodeEngine(cost, **kw).run(batch, backend="numpy")
    _scan_parity(out, ref)
    assert out["n_served"] > 0
    assert eng.replays == eng.chunks - 1 > 0
    if case == "decide":
        assert len({(c, b) for _, c, b in out["decisions"]}) > 1


@pytest.mark.cuda
def test_scan_engine_auto_is_the_card_and_replays_on_a_second_run(
        cuda_device):
    """``backend="auto"`` runs the torch route on ``cuda``; a second run
    of the same engine on the same workload replays the captured chunk
    for every chunk (no new capture) and gives the same result."""
    from repro_torch.serving.scanpath import ScanDecodeEngine
    batch, cost = _scan_workload(30, 9)
    eng = ScanDecodeEngine(cost, c0=8, b0=8)
    r1 = eng.run(batch, backend="auto")
    assert r1["backend"] == "torch"
    assert eng._torch_chunk.device.type == "cuda"
    graph, replays = eng._torch_chunk.step.graph, eng.replays
    r2 = eng.run(batch)
    assert eng._torch_chunk.step.graph is graph
    assert eng.replays - replays == eng.chunks
    _scan_parity(r1, r2)
    _scan_parity(r1, ScanDecodeEngine(cost, c0=8, b0=8).run(
        batch, backend="numpy"))


# --------------------------------------------------------------------------
# on the card: whisper's cross-attention and the prefix / encoder models'
# captured decode
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_routes_agree_on_card(dtype, cuda_device):
    """``_cross_decode`` at whisper-large-v3's cross-attention widths (20
    heads of 64 over 1,500 encoder rows, d_model cut to 256): the kernel
    route (``decode_attention``, lengths 1500) equals the dense softmax
    of the plain route."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    tdt = DTYPES[dtype]
    base = dataclasses.replace(get_config("whisper-large-v3-reduced"),
                               num_heads=20, num_kv_heads=20, head_dim=64,
                               encoder_seq_len=1500)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    dm, hd = base.d_model, 20 * 64

    def w(*shape):
        return (torch.randn(*shape, generator=g, device=cuda_device)
                / shape[0] ** 0.5).to(tdt)

    p = {"norm_cross": w(dm) * 0.1,
         "cross": {"wq": w(dm, hd), "wk": w(dm, hd), "wv": w(dm, hd),
                   "wo": w(hd, dm)}}
    x = torch.randn(4, 1, dm, generator=g, device=cuda_device).to(tdt)
    cache = {n: torch.randn(4, 1500, 20, 64, generator=g,
                            device=cuda_device).to(tdt) for n in ("k", "v")}
    outs = {}
    for on in (True, False):
        before = counters.read()["decode_attention"]
        outs[on] = tfm._cross_decode(
            p, x, cache, dataclasses.replace(base, use_pallas_decode=on))
        torch.cuda.synchronize()
        assert counters.read()["decode_attention"] == before + int(on)
    np.testing.assert_allclose(as_np(outs[True]), as_np(outs[False]),
                               **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b-reduced",
                                  "whisper-large-v3-reduced"])
def test_vlm_audio_captured_decode_equals_eager_on_card(arch, cuda_device):
    """The reduced Qwen2-VL (one image's grid of M-RoPE ids, t = 0 for
    every patch, the decode ids in a static (3, B, 1) tensor the step
    advances on the device) and whisper (the cross K/V written in place
    by the prefill): decode steps replayed from one CUDA graph give the
    eager steps' ids and f32 logits, read nothing back to the host, and
    each replay counts one ``decode_attention`` per layer (two for
    whisper)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.capture import CapturedStep

    cfg = dataclasses.replace(get_config(arch), use_pallas_prefill=True,
                              use_pallas_decode=True)
    model = build_model(cfg, device=cuda_device)
    params = model.init(model.generator(0))
    b, s, steps, p = 2, 9, 5, cfg.num_patch_tokens
    g = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                     device=cuda_device, dtype=torch.int32)}
    first = None
    if p:
        batch["prefix_embeds"] = torch.randn(b, p, cfg.d_model, generator=g,
                                             device=cuda_device)
        pos = torch.arange(p + s, device=cuda_device).repeat(3, b, 1)
        pos[0, :, :p] = 0
        pos[1, :, :p] = torch.arange(p, device=cuda_device) // 2
        pos[2, :, :p] = torch.arange(p, device=cuda_device) % 2
        batch["mrope_positions"] = pos.to(torch.int32)
        first = torch.full((3, b, 1), p + s, dtype=torch.int32,
                           device=cuda_device)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn(b, cfg.encoder_seq_len, cfg.d_model,
                                          generator=g, device=cuda_device)
    vocab = cfg.vocab_size
    with torch.inference_mode():
        cache = model.init_cache(b, p + s + steps + 2)
        ids = torch.zeros(b, dtype=torch.int32, device=cuda_device)
        mpos = None if first is None else first.clone()

    def start():
        lg, _ = model.prefill(params, batch, cache=cache)
        ids.copy_(lg[:, :vocab].argmax(-1))
        if mpos is not None:
            mpos.copy_(first)

    def body():
        lg, _ = model.decode_step(params, cache, ids[:, None], mpos)
        ids.copy_(lg[:, :vocab].argmax(-1))
        if mpos is not None:
            mpos.add_(1)
        return lg

    static = (ids,) if mpos is None else (ids, mpos)
    runs = {}
    for capture in (False, True):
        step = CapturedStep(body, static, capture)
        with torch.inference_mode():
            if capture:
                start()
                step(*static)               # warm-up: eager run + capture
            start()
            logits, got = [], []
            for _ in range(steps):
                if capture:                 # a replay reads nothing back
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    logits.append(step(*static).clone())
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                got.append(ids.clone())
        runs[capture] = (torch.stack(logits), torch.stack(got))
    assert step.replays == steps
    assert step.deltas == {"decode_attention":
                           cfg.num_layers * (2 if cfg.is_encoder_decoder
                                             else 1)}
    (le, ie), (lc, ic) = runs[False], runs[True]
    assert torch.equal(ic, ie)
    np.testing.assert_allclose(as_np(lc), as_np(le), **tol("float32"))


# --------------------------------------------------------------------------
# on the card: the MoE layer, eager and replayed
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [4, 1024])
def test_moe_layer_replay_equals_eager_on_card(tokens, dtype, cuda_device):
    """The single-shard MoE layer (sort dispatch, capacity clamp, batched
    expert products, the deterministic combine) at a decode (4 tokens)
    and a prefill (1,024 tokens, pairs dropped at the served factor
    1.25) size: two eager calls give the same bits, a captured call's
    replay gives them too, and the replay reads nothing back to the
    host."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.serving.capture import CapturedStep

    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b-reduced"),
                              num_experts=64, num_experts_per_tok=8,
                              d_model=256, moe_d_ff=128,
                              moe_capacity_factor=1.25)
    tdt = DTYPES[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = moe.init_moe(gen, cfg, tdt)
    x = torch.randn(2, tokens // 2, 256, generator=gen,
                    device=cuda_device).to(tdt)
    a, _ = moe.moe_fwd(params, x, cfg)
    b, _ = moe.moe_fwd(params, x, cfg)
    assert torch.equal(a, b)
    static = x.clone()
    step = CapturedStep(lambda: moe.moe_fwd(params, static, cfg)[0],
                        (static,))
    step(torch.zeros_like(x))                    # warm-up: the capture
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert step.replays == 1 and torch.equal(got, a)


# --------------------------------------------------------------------------
# training on the card (no kernel: the plain path through autograd)
# --------------------------------------------------------------------------
def _train_steps(arch, dev, steps=2):
    """``steps`` train steps of the reduced ``arch`` in f32 on ``dev``
    from one CPU-drawn ``init_state``; returns the losses and state."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import build_model
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.utils.tree import tree_map_with_path

    cfg = get_config(arch)
    oc = OptConfig()
    cpu = build_model(cfg, device="cpu")
    state = init_state(cpu, cpu.generator(0), oc).as_dict()
    state = tree_map_with_path(lambda _, t: t.to(dev, copy=True), state)
    step = make_train_step(build_model(cfg, device=dev), oc)
    losses = []
    for i in range(steps):
        state, m = step(state, make_batch(cfg, 2, 32, i))
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m-reduced",
                                  "zamba2-2.7b-reduced"])
def test_train_steps_on_card_match_cpu(arch, cuda_device):
    """f32 with TF32 off: losses within 1e-4 relative, the parameters
    within atol 1e-5 / rtol 1e-4 of the same steps on the CPU."""
    from repro_torch.utils.tree import tree_leaves

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, cs = _train_steps(arch, cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu, ps = _train_steps(arch, torch.device("cpu"))
    np.testing.assert_allclose(card, cpu, rtol=1e-4)
    for a, b in zip(tree_leaves(cs["params"]), tree_leaves(ps["params"])):
        np.testing.assert_allclose(as_np(a), as_np(b), atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_train_state_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A card state (a bf16 leaf among f32) saved and restored into
    fresh card tensors: every leaf equal, on the card, in its dtype."""
    from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from repro_torch.utils.tree import tree_leaves, tree_map_with_path

    _, state = _train_steps("smollm-135m-reduced", cuda_device, steps=1)
    state["params"]["final_norm"] = state["params"]["final_norm"].bfloat16()
    f = save_checkpoint(str(tmp_path), state, step=1)
    fresh = tree_map_with_path(lambda _, t: torch.zeros_like(t), state)
    out, meta = restore_checkpoint(f, fresh)
    assert meta["bf16_keys"] == ["params::final_norm"]
    for a, b in zip(tree_leaves(out), tree_leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# published Zamba2's kernel cases (zamba2-7b): grouped B and C, head_dim
# 224 with a softmax scale, the erf GeGLU; ssd_scan's launches by body
# --------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,y", [("float32", 40, "float32"),
                                       ("bfloat16", 1, "float32"),
                                       ("bfloat16", 5, "bfloat16"),
                                       ("bfloat16", 77, "bfloat16"),
                                       ("bfloat16", 130, "float32")])
def test_grouped_ssd_scan_on_card(dtype, t, y, cuda_device):
    """G 2 (head h reads group h // (H / 2)) against the plain versions:
    the recurrence bit for bit, the chunked form as its plain version;
    G 1 as (B, T, 1, N) equals the shared (B, T, N) call bit for bit."""
    dt_, y_dtype = DTYPES[dtype], DTYPES[y]
    x, dt, a_log, _, _, h0 = ssd_inputs(2, t, 4, 64, 64, dt_, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    bm, cm = (torch.randn(2, t, 2, 64, generator=g, device=cuda_device)
              .to(dt_) for _ in range(2))
    got = ssd.ssd_scan(x, dt, a_log, bm, cm, h0, y_dtype=y_dtype)
    if ssd.takes_chunked_form(x):
        want = ssd.ssd_scan_chunked_plain(x, dt, a_log, bm, cm, h0,
                                          y_dtype=y_dtype)
        np.testing.assert_allclose(as_np(got[0]), as_np(want[0]), atol=2e-2,
                                   rtol=2e-2)
        np.testing.assert_allclose(as_np(got[1]), as_np(want[1]), atol=2e-4,
                                   rtol=2e-4)
    else:
        want = ssd.ssd_scan_plain(x, dt, a_log, bm, cm, h0, y_dtype=y_dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    one = ssd.ssd_scan(x, dt, a_log, bm[:, :, :1].contiguous(),
                       cm[:, :, :1].contiguous(), h0, y_dtype=y_dtype)
    shared = ssd.ssd_scan(x, dt, a_log, bm[:, :, 0].contiguous(),
                          cm[:, :, 0].contiguous(), h0, y_dtype=y_dtype)
    assert torch.equal(one[0], shared[0]) and torch.equal(one[1], shared[1])


@pytest.mark.cuda
def test_ssd_scan_counts_its_bodies_on_card(cuda_device):
    """A bf16 call of T >= CHUNKED_MIN_T counts as the chunked form, every
    other call as the recurrence, beside the one ``launches`` count; a
    captured step's replay adds the counts its capture held back."""
    from repro_torch.serving.capture import CapturedStep, event_counts
    x, dt, a_log, bm, cm, h0 = ssd_inputs(1, 32, 2, 64, 64, torch.bfloat16,
                                          cuda_device)
    before = counters.read()
    ssd.ssd_scan(x, dt, a_log, bm, cm, h0)
    ssd.ssd_scan(x[:, :1].contiguous(), dt[:, :1].contiguous(), a_log,
                 bm[:, :1].contiguous(), cm[:, :1].contiguous(), h0)
    after = counters.read()
    assert {k: after[k] - before[k] for k in ("ssd_scan.recurrence",
                                              "ssd_scan.chunked")} == \
        {"ssd_scan.recurrence": 1, "ssd_scan.chunked": 1}
    assert after["ssd_scan"] == before["ssd_scan"] + 2
    step = CapturedStep(lambda: ssd.ssd_scan(x, dt, a_log, bm, cm, h0)[0],
                        (x,))
    step(x)                                   # the warm-up: eager, captured
    counts = event_counts()
    step(x)
    step(x)
    assert step.events == {"ssd_scan.chunked": 1}
    assert event_counts()["ssd_scan.chunked"] == counts["ssd_scan.chunked"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_224_with_a_scale_on_card(dtype, cuda_device):
    """Both attention kernels at D 224 with the scale (224 / 2)^-1/2
    against their plain versions; at the default scale each equals the
    call that passes D^-1/2."""
    dt_, scale = DTYPES[dtype], 112 ** -0.5
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dt_)

    q, k, v = rand(2, 150, 4, 224), rand(2, 150, 2, 224), rand(2, 150, 2, 224)
    for window in (150, 40):
        got = pre.swa_prefill_attention(q, k, v, window, scale=scale)
        want = pre.swa_prefill_plain(q, k, v, window, scale=scale)
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))
    assert torch.equal(pre.swa_prefill_attention(q, k, v, 150),
                       pre.swa_prefill_attention(q, k, v, 150, 224 ** -0.5))
    qd = rand(3, 2, 2, 224)
    lengths = torch.tensor([0, 7, 150], dtype=torch.int32, device=cuda_device)
    got, lse = dec.decode_attention(qd, k[:1].expand(3, -1, -1, -1)
                                    .contiguous(), v[:1].expand(3, -1, -1, -1)
                                    .contiguous(), lengths, True, scale)
    want, lse_p = dec.decode_attention_plain(
        qd, k[:1].expand(3, -1, -1, -1), v[:1].expand(3, -1, -1, -1),
        lengths, True, scale)
    np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))
    np.testing.assert_allclose(as_np(lse), as_np(lse_p), atol=2e-2, rtol=2e-3)
    kk, vv = k[:1].expand(3, -1, -1, -1).contiguous(), \
        v[:1].expand(3, -1, -1, -1).contiguous()
    assert torch.equal(dec.decode_attention(qd, kk, vv, lengths),
                       dec.decode_attention(qd, kk, vv, lengths,
                                            scale=224 ** -0.5))


@pytest.mark.cuda
def test_glu_gate_erf_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    gt, up = (torch.randn(16, 1, 14336, generator=g, device=cuda_device)
              .bfloat16() * 2 for _ in range(2))
    assert torch.equal(gate.glu_gate(gt, up, "geglu_erf"),
                       gate.glu_gate_plain(gt, up, "geglu_erf"))


# --------------------------------------------------------------------------
# the Mamba2 decode step's fused kernels: Zamba2-7B's shapes (d_inner 7168,
# G 2, N 64, conv biases) and zamba2-2.7b's (d_inner 5120, G 1, no biases)
# --------------------------------------------------------------------------
MAMBA2_FORMS = {"zamba2-7b": dict(di=7168, g=2, n=64, h=112, bias=True),
                "zamba2-2.7b": dict(di=5120, g=1, n=64, h=80, bias=False)}


def mamba2_operands(gen, form, rows, leaf):
    """One layer's leaves (``dt_bias``, ``a_log``, ``d_skip`` in ``leaf``,
    the rest bf16) and a decode step's in-projection outputs and state."""
    f = MAMBA2_FORMS[form]
    di, cbc, h = f["di"], 2 * f["g"] * f["n"], f["h"]
    p = {"conv_x": bf16_randn(gen, 4, di, scale=0.5),
         "conv_bc": bf16_randn(gen, 4, cbc, scale=0.5),
         "dt_bias": bf16_randn(gen, h).to(leaf),
         "a_log": bf16_randn(gen, h, scale=0.3).to(leaf),
         "d_skip": bf16_randn(gen, h).to(leaf),
         "norm": bf16_randn(gen, di, scale=0.1)}
    if f["bias"]:
        p["conv_x_bias"] = bf16_randn(gen, di, scale=0.1)
        p["conv_bc_bias"] = bf16_randn(gen, cbc, scale=0.1)
    zx = bf16_randn(gen, rows, 1, 2 * di, scale=2.0)
    bcin = bf16_randn(gen, rows, 1, cbc, scale=2.0)
    dt_raw = bf16_randn(gen, rows, 1, h, scale=4.0)
    state = {"conv_x": bf16_randn(gen, rows, 3, di),
             "conv_bc": bf16_randn(gen, rows, 3, cbc)}
    return f, p, zx, bcin, dt_raw, state


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(MAMBA2_FORMS))
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("leaf", ["float32", "bfloat16"])
def test_mamba2_conv_step_kernel_equals_plain_on_card(form, rows, leaf,
                                                      cuda_device):
    """xc, B, C, dt, a_log and both windows bit for bit, the windows
    shifted in place in the state and into new tensors without ``out``."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    f, p, zx, bcin, dt_raw, state = mamba2_operands(gen, form, rows,
                                                    DTYPES[leaf])
    di = f["di"]
    plain_state = {k: v.clone() for k, v in state.items()}
    before = {k: v.clone() for k, v in state.items()}
    n = counters.read()["mamba2_conv_step"]
    got = conv_step.mamba2_conv_step(p, zx[..., di:], bcin, dt_raw, state,
                                     f["g"], state)
    torch.cuda.synchronize()
    assert counters.read()["mamba2_conv_step"] == n + 1
    want = conv_step.mamba2_conv_step_plain(p, zx[..., di:], bcin, dt_raw,
                                            plain_state, f["g"], plain_state)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert got[1].is_contiguous() and got[2].is_contiguous()
    assert all(torch.equal(state[k], plain_state[k]) for k in state)
    fresh = conv_step.mamba2_conv_step(p, zx[..., di:], bcin, dt_raw, before,
                                       f["g"])
    assert torch.equal(fresh[5], state["conv_x"])
    assert torch.equal(fresh[6], state["conv_bc"])


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(MAMBA2_FORMS))
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("leaf", ["float32", "bfloat16"])
def test_mamba2_gate_norm_kernel_matches_plain_on_card(form, rows, leaf,
                                                       cuda_device):
    """Within add_rms_norm's tolerance (the norm's sum runs in another
    order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    f, p, zx, _, _, _ = mamba2_operands(gen, form, rows, DTYPES[leaf])
    di, h = f["di"], f["h"]
    y = torch.randn(rows, 1, h, di // h, generator=gen, device=cuda_device)
    xh = bf16_randn(gen, rows, 1, h, di // h)
    n = counters.read()["mamba2_gate_norm"]
    got = gate_norm.mamba2_gate_norm(y, xh, p["d_skip"], zx[..., :di],
                                     p["norm"], f["g"], 1e-5)
    torch.cuda.synchronize()
    assert counters.read()["mamba2_gate_norm"] == n + 1
    want = gate_norm.mamba2_gate_norm_plain(y, xh, p["d_skip"], zx[..., :di],
                                            p["norm"], f["g"], 1e-5)
    assert got.shape == want.shape == (rows, 1, di)
    np.testing.assert_allclose(as_np(got), as_np(want), **FUSED_TOL)


@pytest.mark.cuda
def test_mamba2_fused_kernels_refuse_f32_on_card(cuda_device):
    """A CUDA tensor never falls back to the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    f, p, zx, bcin, dt_raw, state = mamba2_operands(gen, "zamba2-2.7b", 1,
                                                    torch.float32)
    di, h = f["di"], f["h"]
    with pytest.raises(ValueError, match="bfloat16"):
        conv_step.mamba2_conv_step(p, zx[..., di:].float(), bcin, dt_raw,
                                   state, 1)
    y = torch.zeros(1, 1, h, di // h, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        gate_norm.mamba2_gate_norm(y, y, p["d_skip"], zx[..., :di].float(),
                                   p["norm"], 1, 1e-5)


@pytest.mark.cuda
def test_zamba2_7b_replay_counts_81_of_each_mamba2_kernel_on_card(
        cuda_device):
    """Published Zamba2 at its widths in bf16, b 1: the captured decode
    entry holds 81 ``mamba2_conv_step`` and 81 ``mamba2_gate_norm``
    launches (one a Mamba2 layer) and 293 ``decode_gemm`` (two a Mamba2
    layer, ten a shared application, the head), every replay adds them,
    and its ids equal the eager entry's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import token_backend as tb
    from repro_torch.serving.capture import launch_counts

    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              use_pallas_prefill=True, use_pallas_decode=True)
    model = build_model(cfg, device=cuda_device)
    params = model.init(model.generator(0))
    b, pl, steps = 1, 32, 4
    want = {"mamba2_conv_step": cfg.num_layers,
            "mamba2_gate_norm": cfg.num_layers,
            "decode_gemm": 2 * cfg.num_layers
            + 10 * len(cfg.hybrid_layer_ids) + 1}
    assert want["mamba2_conv_step"] == 81 and want["decode_gemm"] == 293
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, pl)).astype(np.int32)
    ids = {}
    for capture in (True, False):
        pre_fns, dec_fns = tb.build_token_step_fns(
            model, params, (1,), (b,), pl, max_decode=steps, capture=capture)
        tb.warmup_token_fns(pre_fns, dec_fns, pl)
        if capture:
            deltas = dec_fns[(1, b)].step.deltas
            assert {k: deltas.get(k) for k in want} == want
            before = launch_counts()
        tok, cache = pre_fns[(1, b)](prompt)
        out = [tok.clone()]
        for _ in range(steps):
            tok, cache = dec_fns[(1, b)](cache, tok)
            out.append(tok.clone())
        torch.cuda.synchronize()
        if capture:
            after = launch_counts()
            assert {k: after[k] - before[k] for k in want} == \
                {k: n * steps for k, n in want.items()}
        ids[capture] = torch.stack(out)
        del pre_fns, dec_fns, cache
    assert torch.equal(ids[True], ids[False])


# --------------------------------------------------------------------------
# the decode step's weight products (decode_gemm): every product shape of
# zamba2-7b's and h2o-danube-1.8b's decode steps, (K, (N, ...)), the tied
# head as an (N, K) embedding read in place, and ragged edges
# --------------------------------------------------------------------------
DECODE_GEMM_SHAPES = {
    "zamba2_in_proj": (3584, (14336, 256, 112), False),
    "zamba2_w_out": (7168, (3584,), False),
    "zamba2_qkv": (7168, (7168,), False),
    "zamba2_gate_up": (3584, (14336,), False),
    "zamba2_down": (14336, (3584,), False),
    "zamba2_hybrid_out": (3584, (3584,), False),
    "zamba2_adapter_a": (3584, (128,), False),
    "zamba2_adapter_b": (128, (28672,), False),
    "zamba2_head": (3584, (32000,), True),
    "danube_q_o": (2560, (2560,), False),
    "danube_kv": (2560, (640,), False),
    "danube_gate_up": (2560, (6912,), False),
    "danube_down": (6912, (2560,), False),
    "danube_head": (2560, (32000,), False),
    "ragged": (136, (8, 72, 200), False),
    "ragged_split": (1032, (24,), False),
    "ragged_head": (264, (40,), True),
}


def decode_gemm_operands(gen, k, ns, transposed, rows):
    """x (rows, 1, K) and the weights at the dense init's scale; a
    transposed weight is the (K, N) view of an (N, K) tensor."""
    x = bf16_randn(gen, rows, 1, k)
    ws = [bf16_randn(gen, n, k, scale=k ** -0.5).T if transposed
          else bf16_randn(gen, k, n, scale=k ** -0.5) for n in ns]
    return x, ws


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(DECODE_GEMM_SHAPES))
@pytest.mark.parametrize("rows", [1, 8, 16, 3])
def test_decode_gemm_kernel_matches_plain_on_card(shape, rows, cuda_device):
    """Each output within bf16's tolerance of the plain version (cuBLAS's
    product), one launch for all the weights, the same bits on a second
    call (the cluster's partial sums meet in rank order)."""
    k, ns, transposed = DECODE_GEMM_SHAPES[shape]
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    x, ws = decode_gemm_operands(gen, k, ns, transposed, rows)
    assert dgemm.takes_kernel(x, ws)
    n = counters.read()["decode_gemm"]
    got = dgemm.decode_gemm(x, ws)
    torch.cuda.synchronize()
    assert counters.read()["decode_gemm"] == n + 1
    want = dgemm.decode_gemm_plain(x, ws)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(a), as_np(b), **tol("bfloat16"))
    again = dgemm.decode_gemm(x, ws)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_decode_gemm_refuses_what_it_does_not_take_on_card(cuda_device):
    """A CUDA tensor never falls back to the plain version: f32, 17 rows,
    an N that is not a multiple of 8 and a transposed weight beside
    another are refused."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x, (w,) = decode_gemm_operands(gen, 256, (64,), False, 1)
    for xx, ws in ((x.float(), [w.float()]),
                   (bf16_randn(gen, 17, 1, 256), [w]),
                   (x, [w[:, :60]]),
                   (x, [w, bf16_randn(gen, 64, 256).T])):
        with pytest.raises(ValueError, match="decode_gemm takes"):
            dgemm.decode_gemm(xx, ws)
