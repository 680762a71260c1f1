"""RWKV-6 "Finch": attention-free time mix with data-dependent decay.

Counterpart of ``repro.models.rwkv6``.  Time-mix (WKV6) recurrence per
head, with a state S in R^{D x D}:

    y_t = r_t^T (S_{t-1} + u  k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

The reference runs the recurrence as a ``lax.scan`` (``wkv6_scan``),
or, in the no-cache forward under ``cfg.rwkv_chunked`` with S > 1, in
the chunked form ``wkv6_chunked``.  The port's no-cache forward (the
training path, ``train_form=True``) runs the same two forms
(``wkv6_recurrence`` is the reference's ``wkv6_scan`` step for step).
For prefill and decode, ``wkv6_scan`` routes the recurrence through the
Hopper ``rwkv6_scan`` kernel when asked (the block functions ask with
``cfg.use_pallas_prefill`` for the prefill pass and
``cfg.use_pallas_decode`` for a decode step) and through the kernel's
plain version otherwise.  The decay ``w`` stays f32
from the LoRA to the kernel: rounded to bf16, ``1 - w`` near the init
value 0.9975 would be off by more than half.

When given ``out`` (a layer's views into the decode cache), the time and
channel mix write their new state there in place; the WKV state is
updated by the kernel itself (its output aliases its input state).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan, rwkv6_scan_plain
from repro_torch.models import sharding as sh
from repro_torch.models.common import dense_init, keep_in, linear

LORA_R = 64
DECAY_LORA_R = 128


def init_rwkv6_tmix(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    h = cfg.rwkv_num_heads
    hd = d // h
    dev, f32 = gen.device, torch.float32
    return {
        "mu_x": torch.zeros(d, dtype=dtype, device=dev),
        "mu": torch.zeros(5, d, dtype=dtype, device=dev),     # r,k,v,w,g
        "lora_a": dense_init(gen, (d, 5 * LORA_R), dtype),
        "lora_b": dense_init(gen, (5, LORA_R, d), dtype, fan_in=LORA_R),
        "w_r": dense_init(gen, (d, d), dtype),
        "w_k": dense_init(gen, (d, d), dtype),
        "w_v": dense_init(gen, (d, d), dtype),
        "w_g": dense_init(gen, (d, d), dtype),
        "w_o": dense_init(gen, (d, d), dtype),
        "decay_a": dense_init(gen, (d, DECAY_LORA_R), dtype),
        "decay_b": dense_init(gen, (DECAY_LORA_R, d), dtype,
                              fan_in=DECAY_LORA_R),
        "decay_base": torch.full((d,), -6.0, dtype=f32, device=dev),
        "bonus_u": dense_init(gen, (h, hd), f32, fan_in=hd),
        "ln_scale": torch.ones(d, dtype=f32, device=dev),
        "ln_bias": torch.zeros(d, dtype=f32, device=dev),
    }


def init_rwkv6_cmix(gen: torch.Generator, cfg: ModelConfig, dtype):
    d = cfg.d_model
    return {
        "mu_k": torch.zeros(d, dtype=dtype, device=gen.device),
        "mu_r": torch.zeros(d, dtype=dtype, device=gen.device),
        "w_k": dense_init(gen, (d, cfg.d_ff), dtype),
        "w_v": dense_init(gen, (cfg.d_ff, d), dtype, fan_in=cfg.d_ff),
        "w_r": dense_init(gen, (d, d), dtype),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """prev token's x; x: (B,S,d); prev: (B,d) carried state or None."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return shifted, x[:, -1, :]


def wkv6_scan(r, k, v, w, u, s0=None, *, kernel: bool = False, out=None,
              mesh=None):
    """WKV6 recurrence.  r,k,v: (B,S,H,D); w: (B,S,H,D) f32 decay in
    (0,1); u: (H,D) f32 bonus.  Returns (y (B,S,H,D), s_final (B,H,D,D)).
    ``kernel`` runs the ``rwkv6_scan`` kernel, else its plain version;
    ``out`` receives s_final (it may be ``s0``).  Under ``mesh`` the scan
    runs per rank through ``local_map`` (it is independent per (batch,
    head)): the batch over the data axes, the heads over ``model`` where
    they divide it."""
    scan = rwkv6_scan if kernel else rwkv6_scan_plain
    if mesh is None:
        return scan(r, k, v, w, u, s0, s_out=out)
    y, s_final = _per_rank_scan(scan, mesh, r, k, v, w, u, s0)
    if out is not None:
        out.copy_(s_final)
        s_final = out
    return y, s_final


def _per_rank_scan(scan, mesh, r, k, v, w, u, s0):
    """``scan(r, k, v, w, u, s0) -> (y, s_final)`` on each rank's slice
    through ``local_map``: the batch over the data axes, the heads over
    ``model`` where they divide it."""
    dp = sh.dp_axes(mesh)
    heads = "model" if r.shape[2] % sh.axis_size(mesh, "model") == 0 \
        else None
    seq, st = (dp, None, heads, None), (dp, heads, None, None)
    return sh.local_call(
        lambda r, k, v, w, u, s0: scan(r, k, v, w, u, s0), mesh,
        (seq, seq, seq, seq, (heads, None), None if s0 is None else st),
        [seq, st], r, k, v, w, u, s0)


def wkv6_recurrence(r, k, v, w, u, s0=None):
    """The reference's ``wkv6_scan``, one step at a time with its
    einsums (the no-cache forward without ``cfg.rwkv_chunked``; the
    gradients of the reduced stack are sensitive to the recurrence's
    summation order).  Shapes and returns as ``wkv6_scan``."""
    b, t, h, d = r.shape
    state = (torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    ys = []
    for i in range(t):
        kv = torch.einsum("bhi,bhj->bhij", kf[:, i], vf[:, i])
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, i],
                               state + u[None, :, :, None] * kv))
        state = state * wf[:, i][..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def wkv6_chunked(r, k, v, w, u, s0=None, chunk: int = 32):
    """Chunked-parallel WKV6, the reference's training form.

    The within-chunk decay products factorise as

        s_{t,j} = (r_t * e^{L_{t-1}}) . (k_j * e^{-L_j}),  j < t

    so intra-chunk work is two masked matmuls and the state is carried
    once per chunk.  Per-step log-decays are clamped to >= -2 (w >=
    0.135) to bound e^{-L_j} within f32 for chunk <= 32, as in the
    reference; a ragged T is padded with r = k = v = 0 and w = 1.
    Shapes and returns as ``wkv6_scan``."""
    b, t, h, d = r.shape
    if s0 is None:
        s0 = torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (t + pad) // chunk
    q = chunk
    rs = r.reshape(b, nc, q, h, d).float()
    ks = k.reshape(b, nc, q, h, d).float()
    vs = v.reshape(b, nc, q, h, d).float()
    ws = w.reshape(b, nc, q, h, d).float()

    lw = torch.clamp(torch.log(torch.clamp(ws, min=1e-12)), min=-2.0)
    lcum = torch.cumsum(lw, dim=2)                           # inclusive L_t
    lprev = lcum - lw                                        # L_{t-1}
    r_t = rs * torch.exp(lprev)                              # r~ (B,nc,q,H,D)
    k_t = ks * torch.exp(-lcum)                              # k~
    # intra: strict-causal (t > j) masked matmul + u-diagonal
    scores = torch.einsum("bcthd,bcjhd->bchtj", r_t, k_t)
    qi = torch.arange(q, device=r.device)
    strict = qi[:, None] > qi[None, :]
    scores = torch.where(strict[None, None, None], scores, 0.0)
    # einsum("bcthd,hd,bcthd->bcth", rs, u, ks), pairwise in that order
    diag = torch.einsum("bcthd,bcthd->bcth", rs * u.float(), ks)
    y = torch.einsum("bchtj,bcjhd->bcthd", scores, vs)
    y = y + diag[..., None] * vs

    # inter-chunk: carry the state once per chunk
    ltot = lcum[:, :, -1]                                     # (B,nc,H,D)
    kw = ks * torch.exp(ltot[:, :, None] - lcum)              # (B,nc,q,H,D)
    state = s0.float()
    y_inter = []
    for i in range(nc):
        # r_t already includes the e^{L_{t-1}} factor
        y_inter.append(torch.einsum("bthd,bhde->bthe", r_t[:, i], state))
        state = state * torch.exp(ltot[:, i])[..., None] + torch.einsum(
            "bthd,bthe->bhde", kw[:, i], vs[:, i])
    y = y + torch.stack(y_inter, dim=1)
    y = y.reshape(b, nc * q, h, d)[:, :t]
    return y.to(r.dtype), state


def rwkv6_tmix_fwd(params, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[dict] = None, *, kernel: bool = False,
                   train_form: bool = False, out: Optional[dict] = None,
                   mesh=None):
    """Time mix.  x: (B,S,d).  state: {"shift": (B,d), "wkv": (B,H,D,D)}
    or None (zeros).  Returns ``(y, new_state)``; with ``out`` the new
    state is written into its tensors (which may be ``state``'s).
    ``train_form`` (the no-cache forward) runs the WKV6 as the
    reference's forward does: ``wkv6_chunked`` under ``cfg.rwkv_chunked``
    when S > 1, else ``wkv6_recurrence``; otherwise ``wkv6_scan``
    (``kernel`` as there)."""
    b, s, d = x.shape
    h = cfg.rwkv_num_heads
    hd = d // h
    prev = state["shift"] if state else None
    xprev, shift_out = _token_shift(x, prev)
    sx = xprev - x
    xxx = x + sx * params["mu_x"]
    lora = torch.tanh(linear(xxx, params["lora_a"]))
    lora = lora.reshape(b, s, 5, LORA_R)
    mix = params["mu"] + torch.einsum(
        "bsfr,frd->bsfd", lora.float(),
        params["lora_b"].float()).to(x.dtype)
    xr, xk, xv, xw, xg = [x + sx * mix[:, :, i] for i in range(5)]

    r = sh.split_last(linear(xr, params["w_r"]), h, hd)
    k = sh.split_last(linear(xk, params["w_k"]), h, hd)
    v = sh.split_last(linear(xv, params["w_v"]), h, hd)
    g = F.silu(linear(xg, params["w_g"]))
    dlora = linear(torch.tanh(linear(xw, params["decay_a"])),
                   params["decay_b"])
    w = torch.exp(-torch.exp(params["decay_base"] + dlora.float()))
    w = sh.split_last(w, h, hd)                      # f32, in (0, 1)

    wkv0 = state["wkv"] if state else None
    if train_form:
        form = (wkv6_chunked if cfg.rwkv_chunked and s > 1
                else wkv6_recurrence)
        if mesh is None:
            y, wkv = form(r, k, v, w, params["bonus_u"], wkv0)
        else:
            # both forms are independent per (batch, head): per rank, as
            # the scan of ``wkv6_scan``
            y, wkv = _per_rank_scan(form, mesh, r, k, v, w,
                                    params["bonus_u"], wkv0)
    else:
        y, wkv = wkv6_scan(r, k, v, w, params["bonus_u"], wkv0,
                           kernel=kernel,
                           out=None if out is None else out["wkv"],
                           mesh=mesh)
    # per-head group norm (population variance, as jnp.var)
    yh = sh.split_last(y.float().reshape(b, s, d), h, hd)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = (yh.reshape(b, s, d) * params["ln_scale"]
         + params["ln_bias"]).to(x.dtype)
    y = linear(y * g, params["w_o"])
    return y, {"shift": keep_in(out, "shift", shift_out), "wkv": wkv}


def rwkv6_cmix_fwd(params, x: torch.Tensor, cfg: ModelConfig,
                   state: Optional[dict] = None, *,
                   out: Optional[dict] = None):
    """Channel mix.  state: {"shift": (B,d)} or None; ``out`` as in
    :func:`rwkv6_tmix_fwd`."""
    prev = state["shift"] if state else None
    xprev, shift_out = _token_shift(x, prev)
    sx = xprev - x
    xk = x + sx * params["mu_k"]
    xr = x + sx * params["mu_r"]
    k = torch.square(torch.relu(linear(xk, params["w_k"])))
    kv = linear(k, params["w_v"])
    y = torch.sigmoid(linear(xr, params["w_r"])) * kv
    return y, {"shift": keep_in(out, "shift", shift_out)}


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype, device,
                     layers: int):
    """Zero decode state of ``layers`` layers, each axis led by the layer:
    the reference's per-layer ``init_rwkv6_state`` stacked."""
    d = cfg.d_model
    h = cfg.rwkv_num_heads
    hd = d // h

    def zeros(*shape, dt=dtype):
        return torch.zeros(layers, *shape, dtype=dt, device=device)

    return {
        "tmix": {"shift": zeros(batch, d),
                 "wkv": zeros(batch, h, hd, hd, dt=torch.float32)},
        "cmix": {"shift": zeros(batch, d)},
    }
