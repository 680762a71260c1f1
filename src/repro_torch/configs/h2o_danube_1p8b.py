"""H2O-Danube 1.8B — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L, d_model=2560, 32 heads GQA kv=8 (head_dim 80),
d_ff=6912, vocab=32000, sliding window 4096.  The SWA window bounds the
KV cache, so the long_500k decode shape runs for this arch.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    blocks=("swa+mlp",) * 24,
    window_size=4096,
    tie_embeddings=False,
    source="arXiv:2401.16818",
)
