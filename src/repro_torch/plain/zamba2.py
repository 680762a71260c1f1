"""Plain reference of published Zamba2 (zamba2-7b), in f32.

Zyphra's ``Zamba2ForCausalLM`` (arXiv:2411.15242) written as plain
PyTorch over one sequence: no kernels, no cache, no batching, f32 with
TF32 off (``strict_f32``).  It imports nothing of this package or of
the JAX package, so that the port's model is held against equations
written apart from it.  ``m`` is a dict of the sizes under the port's
field names (``ModelConfig`` / ``Zamba2Config``); ``params`` is the
port's parameter tree (``models/zamba2.py`` documents its layout),
whose leaves may be in any float type: each is widened to f32 where it
is used.  RMSNorm scales by ``1 + scale`` (the port's norm weights are
offsets from one); weights are (in, out).

Per layer, ``x <- x + Mamba2(RMSNorm(x))``; at the hybrid layer of
application j (``m["hybrid_layer_ids"][j]``), with e0 the token
embedding and S the shared block ``j % num_mem_blocks``::

    h = RMSNorm_2d(cat(x, e0))
    a = Attn(h)      q, k, v: 2 d -> H x D, RoPE (split halves, theta)
                     over all D, causal, softmax scale
                     (D / attn_scale_divisor)^-1/2, o: H D -> d
    u = RMSNorm_d(a)
    t = L_j(down(gelu_erf(g) * v)),  [g | v] = W_gu u + B_j(A_j u)
    x <- x + Mamba2(RMSNorm(x + t))

Mamba2 on the normed h: ``[z | x | B | C | dt] = h W`` (B and C in G
groups of N, head k reading group ``k // (H / G)``), a depthwise causal
conv of width W with a bias over ``[x | B | C]`` then SiLU, ``dt =
softplus(dt + dt_bias)``, A = -exp(a_log), the SSD

    s_t = exp(A dt_t) s_{t-1} + dt_t x_t B_t^T;   y_t = s_t C_t + D x_t

then ``out(GroupRMSNorm(y * silu(z)))``, the norm per group of d_inner
/ G channels.  The SSD runs in the exact chunked dual form (chunks of
``CHUNK`` steps, the f32 state passed from chunk to chunk).  The head
is the final RMSNorm and the embedding's transpose (tied) or
``params["head"]``.

Departures from the published model: the weights are random (the
caller's), and the serving path right-pads a prompt with id 0 to its
bucket and attends over the padding, which a caller reproduces by
handing the padded sequence.  ``Zamba2ForCausalLM``'s PyTorch fallback
clamps dt below at ``time_step_min`` (1e-3) while its kernel path with
``time_step_limit`` null, the published setting, does not: this
reference follows the kernel path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 64


def strict_f32() -> None:
    """No TF32 anywhere: an f32 product stays f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def rope(x, pos, theta):
    """Split-halves RoPE over all of D.  x: (S, H, D); pos: (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, h, m, block=256):
    """Causal multi-head attention of the shared block; h: (S, 2 d)."""
    s = h.shape[0]
    nh, nkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    pos = torch.arange(s, device=h.device)
    q = rope(linear(h, p["wq"]).view(s, nh, hd), pos, m["rope_theta"])
    k = rope(linear(h, p["wk"]).view(s, nkv, hd), pos, m["rope_theta"])
    v = linear(h, p["wv"]).view(s, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    scale = (hd / m["attn_scale_divisor"]) ** -0.5
    out = torch.empty(s, nh, hd, device=h.device)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        sc = torch.einsum("qhd,thd->hqt", q[q0:q1], k[:q1]) * scale
        keep = (torch.arange(q0, q1, device=h.device)[:, None]
                >= torch.arange(q1, device=h.device)[None, :])
        sc = sc.masked_fill(~keep, float("-inf"))
        out[q0:q1] = torch.einsum("hqt,thd->qhd", torch.softmax(sc, -1),
                                  v[:q1])
    return linear(out.reshape(s, nh * hd), p["wo"])


def mlp(p, hyb, u, m):
    """The shared MLP with application j's adapter; u: (S, d)."""
    f = m["d_ff"]
    ab = linear(linear(u, hyb["adapter_a"]), hyb["adapter_b"])
    g = linear(u, p["w_gate"]) + ab[:, :f]
    v = linear(u, p["w_up"]) + ab[:, f:]
    return linear(F.gelu(g) * v, p["w_down"])


def shared_block(p, hyb, x, e0, m):
    h = rms_norm(torch.cat([x, e0], dim=-1), p["norm1"], m["norm_eps"])
    u = rms_norm(attention(p["attn"], h, m), p["norm2"], m["norm_eps"])
    return linear(mlp(p["mlp"], hyb, u, m), hyb["w_out"])


def causal_conv(x, w, bias):
    """Depthwise causal conv, then SiLU.  x: (S, C); w: (W, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[i:i + x.shape[0]] * w[i].float() for i in range(width))
    return F.silu(y + bias.float())


def ssd(x, dt, a, b, c, chunk=CHUNK):
    """The SSD in its exact chunked dual form.  x: (S, H, P); dt: (S, H);
    a: (H,) = A; b, c: (S, H, N).  Returns y (S, H, P), without D x."""
    s, nh, p = x.shape
    n = b.shape[-1]
    state = torch.zeros(nh, p, n, device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        t1 = min(t0 + chunk, s)
        xs, d, bs, cs = x[t0:t1], dt[t0:t1], b[t0:t1], c[t0:t1]
        acum = torch.cumsum(d * a, dim=0)                      # (Q, H)
        keep = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool,
                          device=x.device).tril()[:, :, None]
        gate = torch.exp(torch.where(keep, acum[:, None] - acum[None],
                                     float("-inf")))          # (i, j, H)
        cb = torch.einsum("ihn,jhn->ijh", cs, bs)
        y = torch.einsum("ijh,jhp->ihp", cb * gate * d[None], xs)
        y = y + torch.exp(acum)[..., None] * torch.einsum(
            "ihn,hpn->ihp", cs, state)
        w = torch.exp(acum[-1][None] - acum) * d               # (Q, H)
        state = (torch.exp(acum[-1])[:, None, None] * state
                 + torch.einsum("jhp,jhn->hpn", xs * w[..., None], bs))
        ys.append(y)
    return torch.cat(ys, dim=0)


def mamba2(p, h, m):
    """The Mamba2 mixer on the normed h (S, d)."""
    s = h.shape[0]
    di = m["ssm_expand"] * m["d_model"]
    n, g, hp = m["ssm_state_dim"], m["ssm_ngroups"], m["ssm_head_dim"]
    nh = di // hp
    zx = linear(h, p["w_zx"])
    z = zx[:, :di]
    xin = causal_conv(zx[:, di:], p["conv_x"], p["conv_x_bias"])
    bc = causal_conv(linear(h, p["w_bc"]), p["conv_bc"], p["conv_bc_bias"])
    dt = F.softplus(linear(h, p["w_dt"]) + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    bm = bc[:, :g * n].view(s, g, n).repeat_interleave(nh // g, dim=1)
    cm = bc[:, g * n:].view(s, g, n).repeat_interleave(nh // g, dim=1)
    x = xin.view(s, nh, hp)
    y = ssd(x, dt, a, bm, cm) + p["d_skip"].float()[:, None] * x
    v = (y.reshape(s, di) * F.silu(z)).view(s, g, di // g)
    v = rms_norm(v, p["norm"].view(g, di // g), m["norm_eps"])
    return linear(v.reshape(s, di), p["w_out"])


@torch.no_grad()
def hidden(params, tokens, m):
    """The residual stream after the last layer, (S, d)."""
    x = params["embed"][tokens].float()
    e0 = x
    apps = {i: j for j, i in enumerate(m["hybrid_layer_ids"])}
    for i, p in enumerate(params["layers"]):
        h = x
        if i in apps:
            j = apps[i]
            blk = params["shared_blocks"][j % m["num_mem_blocks"]]
            h = x + shared_block(blk, p["hybrid"], x, e0, m)
        x = x + mamba2(p["mamba"], rms_norm(h, p["norm1"], m["norm_eps"]), m)
    return x


@torch.no_grad()
def logits(params, tokens, rows, m):
    """Logits (len(rows), vocab) at positions ``rows`` of ``tokens``
    (S,), over the whole sequence with no cache."""
    x = rms_norm(hidden(params, tokens, m)[rows], params["final_norm"],
                 m["norm_eps"])
    w = params["embed"].T if m["tie_embeddings"] else params["head"]
    return linear(x, w)[:, :m["vocab_size"]]
