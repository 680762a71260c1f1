"""DeepSeek-V3 671B — MoE with MLA, 1 shared + 256 routed experts (top-8), MTP.

[arXiv:2412.19437] 61L, d_model=7168, 128 heads, MoE expert d_ff=2048,
vocab=129280.  First 3 layers are dense (d_ff=18432 per the paper); the
assigned d_ff=2048 is the routed-expert inner dim.  MLA dims per the paper:
q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
Aux-loss-free sigmoid routing; multi-token prediction depth 1.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                      # dense layers (first_k_dense)
    vocab_size=129280,
    blocks=("mla+mlp",) * 3 + ("mla+moe",) * 58,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    moe_router_kind="sigmoid",
    mtp_depth=1,
    rope_theta=10000.0,
    tie_embeddings=False,
    source="arXiv:2412.19437",
)
