"""Gemma 2B — dense decoder with GeGLU, head_dim=256, MQA (kv=1).

[arXiv:2403.08295] 18L, d_model=2048, 8 heads, kv=1 (multi-query),
d_ff=16384, vocab=256000, tied embeddings, GeGLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    blocks=("attn+mlp",) * 18,
    mlp_kind="geglu",
    scale_embed=True,
    tie_embeddings=True,
    source="arXiv:2403.08295",
)
