"""Plain PyTorch pieces of the references, in f32 (or an emulated fp8).

Nothing here imports the program.  Every weight comes in as the
benchmark drew it (bf16 or f32) and is widened to f32 where it is used.
``Precision`` says how a matrix product rounds its operands:

- ``f32``: both operands in f32, TF32 off (``strict_f32`` sets the
  switches), the reference itself;
- ``fp8``: the control.  Both operands of every weight product are
  rounded to float8 e4m3 (the activation with one scale per row, the
  weight with one scale per output column, each scale putting the
  largest magnitude at e4m3's 448) and the product is taken in f32:
  the precision below the configuration's bf16 that a later change
  would be tempted to serve in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_f32() -> None:
    """No TF32 anywhere: an f32 product stays f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded through e4m3 with one scale per slice along ``dim``."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w``, w in (in, out) layout, in f32 or with fp8 operands."""
    x, w = x.float(), w.float()
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + scale): the program's norm, whose scale is
    stored as an offset from one."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding, split halves.  x: (S, H, D); pos: (S,)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                         dtype=torch.float32) / d)
    ang = pos.float()[:, None] * freqs                      # (S, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, h: torch.Tensor, m: dict, window: int,
              precision: str, block: int = 1024) -> torch.Tensor:
    """Causal grouped-query attention over the last ``window`` positions
    (a key at p is seen by the query at q when 0 <= q - p < window).
    h: (S, d_model) normed input; returns (S, d_model)."""
    s = h.shape[0]
    nh, nkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    pos = torch.arange(s, device=h.device)
    q = rope(linear(h, p["wq"], precision).view(s, nh, hd), pos,
             m["rope_theta"])
    k = rope(linear(h, p["wk"], precision).view(s, nkv, hd), pos,
             m["rope_theta"])
    v = linear(h, p["wv"], precision).view(s, nkv, hd)
    g = nh // nkv
    out = torch.empty(s, nh, hd, device=h.device)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        k0 = max(0, q0 - window + 1)
        qb = q[q0:q1].view(q1 - q0, nkv, g, hd)
        sc = torch.einsum("qkgd,tkd->kgqt", qb, k[k0:q1]) * hd ** -0.5
        rel = (torch.arange(q0, q1, device=h.device)[:, None]
               - torch.arange(k0, q1, device=h.device)[None, :])
        sc = sc.masked_fill(~((rel >= 0) & (rel < window)), float("-inf"))
        pr = torch.softmax(sc, dim=-1)
        out[q0:q1] = torch.einsum("kgqt,tkd->qkgd", pr, v[k0:q1]).reshape(
            q1 - q0, nh, hd)
    return linear(out.reshape(s, nh * hd), p["wo"], precision)


def mlp(p: dict, h: torch.Tensor, kind: str, precision: str) -> torch.Tensor:
    """The gated feed-forward: act(h W_gate) * (h W_up), then W_down."""
    gate = linear(h, p["w_gate"], precision)
    if kind == "swiglu":
        act = F.silu(gate)
    elif kind == "geglu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return linear(act * linear(h, p["w_up"], precision), p["w_down"],
                  precision)


def head_logits(params: dict, x: torch.Tensor, m: dict,
                precision: str) -> torch.Tensor:
    """Final norm and the output head (the embedding's transpose when the
    two are tied); x: (R, d_model) -> (R, vocab)."""
    x = rms_norm(x, params["final_norm"], m["norm_eps"])
    w = params["embed"].T if m["tie_embeddings"] else params["head"]
    return linear(x, w, precision)[:, :m["vocab_size"]]


def attention_layout(m: dict) -> dict:
    d, nh, nkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return {"wq": ((d, nh * hd), "dense", d), "wk": ((d, nkv * hd), "dense", d),
            "wv": ((d, nkv * hd), "dense", d),
            "wo": ((nh * hd, d), "dense", nh * hd)}


def mlp_layout(m: dict) -> dict:
    d, f = m["d_model"], m["d_ff"]
    return {"w_gate": ((d, f), "dense", d), "w_up": ((d, f), "dense", d),
            "w_down": ((f, d), "dense", f)}


def embed_layout(m: dict) -> dict:
    v = -(-m["vocab_size"] // 128) * 128      # the program pads to 128
    out = {"embed": ((v, m["d_model"]), "embed", 0),
           "final_norm": ((m["d_model"],), "norm", 0)}
    if not m["tie_embeddings"]:
        out["head"] = ((m["d_model"], v), "dense", m["d_model"])
    return out
