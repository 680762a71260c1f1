"""Kimi K2 — trillion-param MoE, 384 experts top-8 (paper-table variant).

[arXiv:2501.kimi2] 61L, d_model=7168, 64 heads with GQA kv=8 (as assigned),
MoE expert d_ff=2048, vocab=163840, 1 shared expert, first layer dense,
sigmoid (aux-loss-free) routing.  head_dim=128 (q width 8192 > d_model,
as in the K2 family).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                      # dense first layer
    vocab_size=163840,
    blocks=("attn+mlp",) * 1 + ("attn+moe",) * 60,
    num_experts=384,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=1,
    moe_router_kind="sigmoid",
    rope_theta=50000.0,
    tie_embeddings=False,
    source="arXiv:2501.kimi2",
)
