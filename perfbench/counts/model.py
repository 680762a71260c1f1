"""Model FLOPs of the useful work of a served gang, from the configuration
file's shapes: multiply-adds count two operations.

Useful work is what a request asked for: its real prompt tokens in the
prefill (not the bucket's padding, not the batch's filler rows), the
head once for its first token, and one decode step per token it
streams (not the slots that keep stepping after their stream ended).
Per token: every weight product and the causal attention over the keys
the window keeps (QK^T and PV: 4 H D per key).  Counted for the
``swa+mlp`` stack; another block kind is refused.
"""
from __future__ import annotations


def _attn_weights(m):
    d, h, kv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return d * h * hd * 2 + d * kv * hd * 2


def _mlp_weights(m):
    return 3 * m["d_model"] * m["d_ff"]


def _check(m) -> None:
    if m["block"] != "swa+mlp":
        raise ValueError(f"no FLOP count for block {m['block']!r}")


def attention_layers(m) -> int:
    """How many attention layers one token passes."""
    _check(m)
    return m["num_layers"]


def attention_window(m) -> int:
    _check(m)
    return m["window_size"]


def token_flops(m) -> float:
    """Operations per token outside attention's cores and the head."""
    _check(m)
    return 2.0 * m["num_layers"] * (_attn_weights(m) + _mlp_weights(m))


def head_flops(m) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def attn_core_flops(m, keys: int) -> float:
    """QK^T and PV of one query over ``keys`` keys, in every attention layer."""
    return 4.0 * m["num_heads"] * m["head_dim"] * keys * attention_layers(m)


def prefill_useful(m, prompt_tokens: int) -> float:
    w = min(attention_window(m), prompt_tokens)
    keys = w * (w + 1) // 2 + (prompt_tokens - w) * w
    return (prompt_tokens * token_flops(m) + head_flops(m)
            + attn_core_flops(m, 1) * keys)


def decode_useful(m, position: int) -> float:
    """One streamed token at ``position`` (its keys: the window's)."""
    return (token_flops(m) + head_flops(m)
            + attn_core_flops(m, min(position + 1, attention_window(m))))
