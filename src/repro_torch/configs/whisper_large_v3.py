"""Whisper large-v3 — encoder-decoder audio transformer backbone.

[arXiv:2212.04356] 32 encoder + 32 decoder layers, d_model=1280, 20 heads
(kv=20), d_ff=5120, vocab=51866.  The mel-spectrogram + conv frontend is a
STUB per the assignment carve-out: ``input_specs()`` supplies precomputed
frame embeddings of shape (B, 1500, d_model).  Learned positional
embeddings (frontend conv positionality is stubbed away with the conv).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,                # padded internally to 51968 for sharding
    blocks=("attn+mlp",) * 32,
    mlp_kind="gelu",
    rope_kind="learned",
    is_encoder_decoder=True,
    encoder_layers=32,
    encoder_seq_len=1500,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
