"""SmolLM-360M — llama-architecture small dense model.

[hf:HuggingFaceTB/SmolLM-135M family] 32L, d_model=960, 15 heads GQA kv=5,
d_ff=2560, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    blocks=("attn+mlp",) * 32,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
