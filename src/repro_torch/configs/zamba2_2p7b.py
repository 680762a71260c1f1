"""Zamba2 2.7B — hybrid: Mamba2 backbone + one shared attention block.

[arXiv:2411.15242] 54 Mamba2 layers, d_model=2560, ssm_state=64,
d_inner=2*d_model (80 SSD heads of dim 64).  A single SHARED
attention(+MLP d_ff=10240) block (32 heads, head_dim 80) is applied
before every 6th Mamba2 layer (9 applications, one weight set).  For
serving, the shared attention uses a sliding window (4096), kept in a
ring buffer of ``min(4096, cache_len)`` slots per application.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    blocks=("mamba2+none",) * 54,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    shared_attn_window=4096,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)
