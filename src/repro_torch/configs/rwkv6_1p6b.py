"""RWKV-6 "Finch" 1.6B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 24L, d_model=2048 (32 heads of 64), d_ff=7168 (channel
mix), vocab=65536.  Decode state is O(1) per layer (token-shift vectors +
a 32x64x64 WKV state), so all decode shapes including long_500k run.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    blocks=("rwkv6+rwkv_cm",) * 24,
    rope_kind="none",
    tie_embeddings=False,
    source="arXiv:2404.05892",
)
