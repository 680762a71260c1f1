"""Zamba2 7B — published Zamba2 (Zyphra/Zamba2-7B-Instruct, config.json).

[arXiv:2411.15242] 81 Mamba2 layers, d_model 3584, expand 2 (d_inner
7168, 112 SSD heads of 64), state 64 in 2 groups of B and C, conv 4.
13 of them are hybrid (ids 6, 11, 17, ..., 77): two shared blocks,
alternating by application, read the concatenated (x, embedding) at
2 d; attention 32 heads of 224 (MHA) with RoPE over all 224 dims and
the softmax scale (224 / 2)^-1/2; an exact-GELU gated MLP of 14336 with
a rank-128 adapter per application; each application's output goes
through the layer's own d x d linear into the Mamba2 input only
(``Zamba2Config``).  Vocab 32000, tied embeddings (the HF default), no
window: every application keeps a full-length KV cache.  Not one of
the reference's architectures: ``get_config`` resolves it, ``ARCH_IDS``
does not list it.
"""
from repro_torch.configs.base import Zamba2Config

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = Zamba2Config(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    blocks=("mamba2+none",) * 81,
    rope_theta=10000.0,
    mlp_kind="geglu_erf",
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_expand=2,
    hybrid_layer_ids=HYBRID_LAYER_IDS,
    num_mem_blocks=2,
    adapter_rank=128,
    ssm_ngroups=2,
    attn_scale_divisor=2,
    norm_eps=1e-5,
    tie_embeddings=True,
    source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json",
)
