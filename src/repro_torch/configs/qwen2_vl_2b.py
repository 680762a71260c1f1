"""Qwen2-VL 2B — VLM text decoder with M-RoPE and dynamic resolution.

[arXiv:2409.12191] 28L, d_model=1536, 12 heads GQA kv=2, d_ff=8960,
vocab=151936.  The ViT vision encoder + projector is a STUB per the
assignment carve-out: ``input_specs()`` supplies precomputed patch
embeddings (B, num_patch_tokens, d_model); the decoder applies 3-D M-RoPE
(temporal/height/width sections 16/24/24 over the 64-dim rope half).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    blocks=("attn+mlp",) * 28,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    num_patch_tokens=256,
    tie_embeddings=True,
    source="arXiv:2409.12191",
)
