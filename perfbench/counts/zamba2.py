"""Operations and bytes of published Zamba2 (zamba2-7b), from the
configuration file's shapes: ``ssd_scan``'s calls as issued, and the
model FLOPs of the useful work.  Multiply-adds count two operations.

``ssd_scan`` (one call per layer and step: T = the bucket in a
prefill, T = 1 with an f32 y in a decode step): the least bytes read x,
dt, B and C (G groups) and a_log once, write y once, and read and write
the f32 state; its operations are the recurrence's two multiply-adds
per state element and step (the update and the output), on the bf16
peak, which the bytes outweigh at every served shape.  The attention
kernels' calls are ``kernels.prefill_bound`` / ``decode_bound`` at head
dim 224, one per application of a shared block.

Useful work, per token: every weight product of the 81 Mamba2 layers
(in_proj, out_proj, the depthwise convs) and, at each of the 13
applications, the shared block (q, k, v from 2 d, o, gate, up, down),
the adapter and ``L_j``; the SSD's four operations per state element;
the causal attention over the keys before it (4 H D per key); the head
once per request in the prefill and once per streamed token.
"""
from __future__ import annotations

from perfbench.counts.peaks import ELEMENT_BYTES


def _sizes(m):
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"], m["ssm_ngroups"] * m["ssm_state_dim"]


def applications(m) -> int:
    return len(m["hybrid_layer_ids"])


def ssd_bound(m, b, t, y_dtype="bfloat16"):
    """One ``ssd_scan`` call over B b, T t: (bytes, operations, dtype)."""
    di, h, gn = _sizes(m)
    elt = ELEMENT_BYTES[m["dtype"]]
    state = 4 * b * di * m["ssm_state_dim"]
    nbytes = (b * t * (di * elt + h * 4 + 2 * gn * elt
                       + di * ELEMENT_BYTES[y_dtype]) + 4 * h + 2 * state)
    return nbytes, 4.0 * b * t * di * m["ssm_state_dim"], "bfloat16"


def token_flops(m) -> float:
    """Operations per token outside the attention cores and the head."""
    d, f, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    di, h, gn = _sizes(m)
    conv = di + 2 * gn
    mamba = d * (di + conv + h) + di * d + m["ssm_conv_width"] * conv
    inner = m["num_heads"] * m["head_dim"]
    kv = m["num_kv_heads"] * m["head_dim"]
    shared = (2 * d * (inner + 2 * kv) + inner * d + 3 * d * f
              + d * r + r * 2 * f + d * d)
    ssd = 2 * di * m["ssm_state_dim"]
    return 2.0 * (m["num_layers"] * (mamba + ssd)
                  + applications(m) * shared)


def head_flops(m) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def attn_core_flops(m, keys: int) -> float:
    """QK^T and PV of one query over ``keys`` keys, at every application."""
    return 4.0 * m["num_heads"] * m["head_dim"] * keys * applications(m)


def prefill_useful(m, prompt_tokens: int) -> float:
    keys = prompt_tokens * (prompt_tokens + 1) // 2
    return (prompt_tokens * token_flops(m) + head_flops(m)
            + attn_core_flops(m, keys))


def decode_useful(m, position: int) -> float:
    """One streamed token at ``position`` (its keys: every one before)."""
    return token_flops(m) + head_flops(m) + attn_core_flops(m, position + 1)
