"""The chunked training forms, ``ssd_chunked`` (Mamba2) and
``wkv6_chunked`` (RWKV6), against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed as ``tests/test_kernels.py``
draws them (``test_ssd_scan_sweep``: dt after a softplus, a_log * 0.3,
h0 * 0.1; ``test_wkv6_chunked_matches_scan``: r, k, v * 0.5, decays
uniform in (0.7, 0.999), s0 * 0.1).  Cases: ragged S, a carried state,
two chunk sizes; the values and the gradients (a vector-Jacobian
product with a random cotangent, through ``jax.vjp`` and autograd).
Tolerances: against the reference's same function, for WKV the
outputs within atol 1e-5 / rtol 1e-5 and the gradients within 1e-4, for
SSD both within the repo's SSD f32 tolerance, 2e-4 (a chunk of 128
steps sums as many terms, and XLA contracts the three-operand einsums
in another order); against the port's plain scans (``ssd_scan_plain``,
``rwkv6_scan_plain``), the repo's own: SSD f32 2e-4
(``test_ssd_scan_sweep``), WKV atol 1e-4
(``test_wkv6_chunked_matches_scan``).  Where a chunk of 128 steps sums
its decay past ~88, the reference's gradient of dt and a_log is NaN
(``test_ssd_chunked_gradient_finite_past_the_exp_range`` says why):
there the port's must be finite, and that test holds it to the plain
recurrence's gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm2
from repro.models import rwkv6 as jrk
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan.ops import ssd_scan_plain
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rwkv6 as trk


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the test runner's parallel
    workers would otherwise oversubscribe the cores, and a training
    test's many small ops slow tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def softplus(x):
    return np.log1p(np.exp(x))


def ssd_inputs(b, t, h, p, n, seed, dt=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dts = (softplus(rng.standard_normal((b, t, h))).astype(np.float32)
           if dt is None else np.full((b, t, h), dt, np.float32))
    alog = (rng.standard_normal((h,)) * 0.3).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dts, alog, bm, cm, h0


def wkv_inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.standard_normal((b, t, h, d)) * 0.5).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = rng.uniform(0.7, 0.999, (b, t, h, d)).astype(np.float32)
    u = (rng.standard_normal((h, d)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, d, d)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def tensors(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def vjp_both(jfn, tfn, arrays, seed):
    """Outputs and input gradients of ``jfn`` (JAX) and ``tfn`` (torch)
    on the same arrays, against the same random cotangents (one per
    output)."""
    jout, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    rng = np.random.default_rng(seed)
    cots = [rng.standard_normal(o.shape).astype(np.float32) for o in jout]
    jgrads = pull(tuple(jnp.asarray(c) for c in cots))
    ts = tensors(arrays)
    tout = tfn(*ts)
    tgrads = torch.autograd.grad(tout, ts, [torch.from_numpy(c) for c in cots],
                                 allow_unused=True)
    return jout, jgrads, tout, tgrads


def close(out, ref, tol):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    np.testing.assert_allclose(out, np.asarray(ref), atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# ssd_chunked
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (1, 16, 1, 16, 8, 8),
    (2, 77, 3, 32, 16, 16),       # ragged: 77 = 4 x 16 + 13
    (2, 128, 2, 64, 64, 64),
    (1, 300, 2, 16, 16, 128),     # ragged at the default chunk
])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_reference(b, t, h, p, n, chunk, carried):
    x, dt, alog, bm, cm, h0 = ssd_inputs(b, t, h, p, n, seed=t + chunk)
    arrays = [x, dt, alog, bm, cm] + ([h0] if carried else [])

    def jfn(x, dt, alog, bm, cm, h0=None):
        return jm2.ssd_chunked(x, dt, alog, bm, cm, chunk=chunk, h0=h0)

    def tfn(x, dt, alog, bm, cm, h0=None):
        return tm2.ssd_chunked(x, dt, alog, bm, cm, chunk=chunk, h0=h0)

    jout, jg, tout, tg = vjp_both(jfn, tfn, arrays, seed=1)
    assert tout[0].shape == (b, t, h, p) and tout[1].shape == (b, h, p, n)
    for o, r in zip(tout, jout):
        close(o, r, 2e-4)
    for o, r in zip(tg, jg):
        if np.isfinite(np.asarray(r)).all():
            close(o, r, 2e-4)
        else:                       # the reference's NaN past exp's range
            assert chunk == 128 and torch.isfinite(o).all()


@pytest.mark.parametrize("t,chunk", [(77, 16), (77, 32), (256, 128)])
def test_ssd_chunked_matches_the_plain_scan(t, chunk):
    """The chunked form against the port's plain recurrence (the
    ``ssd_scan`` kernel's plain version), at the repo's SSD f32
    tolerance, with a carried state."""
    x, dt, alog, bm, cm, h0 = map(torch.from_numpy,
                                  ssd_inputs(2, t, 3, 16, 16, seed=t))
    y1, h1 = tm2.ssd_chunked(x, dt, alog, bm, cm, chunk=chunk, h0=h0)
    y2, h2 = ssd_scan_plain(x, dt, alog, bm, cm, h0)
    torch.testing.assert_close(y1, y2, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h1, h2, atol=2e-4, rtol=2e-4)


def test_ssd_chunked_continues_its_state():
    """[0:T] in one call equals [0:T/2] then [T/2:T] from its state."""
    x, dt, alog, bm, cm, _ = map(torch.from_numpy,
                                 ssd_inputs(2, 96, 2, 16, 8, seed=5))
    y, hf = tm2.ssd_chunked(x, dt, alog, bm, cm, chunk=32)
    ya, ha = tm2.ssd_chunked(x[:, :48], dt[:, :48], alog, bm[:, :48],
                             cm[:, :48], chunk=32)
    yb, hb = tm2.ssd_chunked(x[:, 48:], dt[:, 48:], alog, bm[:, 48:],
                             cm[:, 48:], chunk=32, h0=ha)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(hb, hf, atol=1e-5, rtol=1e-5)


def test_ssd_chunked_gradient_finite_past_the_exp_range():
    """A chunk whose decay sums past ~88 (dt 0.8 over 128 steps): the
    reference exponentiates the masked upper triangle too and its dt
    gradient is NaN (0 * inf); the port masks before the exp, so its
    gradient is finite and agrees with the plain recurrence's."""
    x, dt, alog, bm, cm, _ = ssd_inputs(1, 128, 2, 8, 8, seed=7, dt=0.8)
    alog = np.zeros_like(alog)
    _, jg = jax.vjp(lambda d: jm2.ssd_chunked(
        jnp.asarray(x), d, jnp.asarray(alog), jnp.asarray(bm),
        jnp.asarray(cm))[0], jnp.asarray(dt))
    (g_ref,) = jg(jnp.ones(x.shape, jnp.float32))
    assert not np.isfinite(np.asarray(g_ref)).all()

    grads = []
    for fn in (lambda *a: tm2.ssd_chunked(*a)[0],
               lambda *a: ssd_scan_plain(*a)[0]):
        d = torch.from_numpy(dt).requires_grad_()
        y = fn(torch.from_numpy(x), d, torch.from_numpy(alog),
               torch.from_numpy(bm), torch.from_numpy(cm))
        grads.append(torch.autograd.grad(y.sum(), d)[0])
    assert torch.isfinite(grads[0]).all()
    torch.testing.assert_close(grads[0], grads[1], atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------------------
# wkv6_chunked
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", [77, 64])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("carried", [False, True])
def test_wkv6_chunked_matches_reference(t, chunk, carried):
    r, k, v, w, u, s0 = wkv_inputs(2, t, 3, 16, seed=t + chunk)
    arrays = [r, k, v, w, u] + ([s0] if carried else [])

    def jfn(r, k, v, w, u, s0=None):
        return jrk.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)

    def tfn(r, k, v, w, u, s0=None):
        return trk.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)

    jout, jg, tout, tg = vjp_both(jfn, tfn, arrays, seed=2)
    for o, r_ in zip(tout, jout):
        close(o, r_, 1e-5)
    for o, r_ in zip(tg, jg):
        close(o, r_, 1e-4)


@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv6_chunked_matches_the_plain_scan(chunk):
    """The chunked form against the port's plain recurrence (the
    ``rwkv6_scan`` kernel's plain version) at the repo's tolerance for
    this pair, atol 1e-4, ragged T and a carried state."""
    r, k, v, w, u, s0 = map(torch.from_numpy, wkv_inputs(2, 77, 3, 16, 3))
    y1, s1 = trk.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
    y2, s2 = rwkv6_scan_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=0)
    torch.testing.assert_close(s1, s2, atol=1e-4, rtol=0)


def test_wkv6_recurrence_matches_reference_scan():
    """``wkv6_recurrence`` (the port's no-cache forward without
    ``rwkv_chunked``) is the reference's ``wkv6_scan``: values and
    gradients."""
    r, k, v, w, u, s0 = wkv_inputs(2, 19, 3, 16, seed=4)
    jout, jg, tout, tg = vjp_both(jrk.wkv6_scan, trk.wkv6_recurrence,
                                  [r, k, v, w, u, s0], seed=3)
    for o, r_ in zip(tout, jout):
        close(o, r_, 1e-5)
    for o, r_ in zip(tg, jg):
        close(o, r_, 1e-4)


def test_wkv6_chunked_clamps_the_log_decay():
    """Decays below e^-2 are clamped to it, as in the reference (the
    two agree there too)."""
    r, k, v, w, u, s0 = wkv_inputs(1, 40, 2, 8, seed=6)
    w[:, 5:9] = 0.01
    yj, sj = jrk.wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u, s0)))
    yt, st = trk.wkv6_chunked(*map(torch.from_numpy, (r, k, v, w, u, s0)))
    close(yt, yj, 1e-5)
    close(st, sj, 1e-5)
