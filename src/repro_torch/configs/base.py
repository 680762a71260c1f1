"""Model configuration dataclass.

Copy of ``repro.configs.base.ModelConfig`` with the same field names and
defaults, so a config maps one to one between the packages, cut to the
fields' declaration, ``padded_vocab``, ``d_inner``, ``ssm_num_heads``,
``rwkv_num_heads``, ``uses_moe``, ``mixer_kinds``, ``param_count()``,
``active_param_count()`` and ``reduced()`` (with its MoE branch, the
no-drop capacity factor, and its MLA widths), and ``InputShape`` /
``INPUT_SHAPES``.  The port's models run only what they implement
(``models.api.build_model`` refuses the rest).

``use_pallas_prefill`` / ``use_pallas_decode`` keep the reference's
names with a wider meaning: they route the prefill pass and the decode
step through the port's Hopper kernels (``repro_torch.kernels``),
whatever the mixer.  For attention that is ``swa_prefill`` and
``decode_attention``; for RWKV-6 it is the WKV6 recurrence on the
``rwkv6_scan`` kernel and for Mamba2 the SSD recurrence on the
``ssd_scan`` kernel, which the reference never routes to its Pallas
kernels.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

# Block kinds: each layer is "<mixer>+<ffn>".
#   mixers: attn | swa | mla | mamba2 | rwkv6
#   ffns:   mlp  | moe | rwkv_cm | none
MIXERS = ("attn", "swa", "mla", "mamba2", "rwkv6")
FFNS = ("mlp", "moe", "rwkv_cm", "none")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- layer stack ------------------------------------------------------
    # per-layer block kind; if empty, derived as ("attn+mlp",) * num_layers
    blocks: Tuple[str, ...] = ()

    # --- attention --------------------------------------------------------
    window_size: int = 0               # >0 => sliding-window attention for "swa"
    rope_theta: float = 10000.0
    rope_kind: str = "standard"        # standard | mrope | none | learned
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    qk_norm: bool = False
    logit_softcap: float = 0.0

    # --- MLA (DeepSeek-style multi-head latent attention) ------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ----------------------------------------------------------------
    mlp_kind: str = "swiglu"           # swiglu | geglu | gelu
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                  # expert inner dim (d_ff used for dense layers)
    first_k_dense: int = 0             # leading dense layers (DeepSeek)
    moe_capacity_factor: float = 1.25
    moe_router_kind: str = "softmax"   # softmax | sigmoid (DeepSeek-V3)
    moe_aux_loss_coef: float = 0.001
    mtp_depth: int = 0                 # multi-token-prediction extra depth (DeepSeek)

    # --- SSM (Mamba2) -------------------------------------------------------
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    shared_attn_every: int = 0         # zamba2: shared attn block every k layers
    shared_attn_window: int = 0        # window for the shared attn block when serving

    # --- enc-dec (whisper) ---------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0           # frames after the (stubbed) conv frontend

    # --- vlm -----------------------------------------------------------------
    num_patch_tokens: int = 0          # prefix patch embeddings from stub encoder

    # --- performance knobs ----------------------------------------------------
    attn_batch_parallel: bool = False  # reference only: sharded attention
    moe_partial_ep: bool = False       # reference only: expert-parallel serving
    use_pallas_decode: bool = False    # decode step's kernel: attention via
                                       # the Hopper decode_attention kernel,
                                       # RWKV-6 WKV6 via rwkv6_scan, Mamba2
                                       # SSD via ssd_scan (T = 1)
    use_pallas_prefill: bool = False   # prefill pass's kernel: attention via
                                       # swa_prefill (full causal == window
                                       # >= S), RWKV-6 WKV6 via rwkv6_scan,
                                       # Mamba2 SSD via ssd_scan (T =
                                       # prompt); serving path only
    rwkv_chunked: bool = False         # chunked-parallel WKV6 in the
                                       # no-cache forward (training)
    # --- numerics ------------------------------------------------------------
    scale_embed: bool = False          # gemma: multiply embeddings by sqrt(d)
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "bfloat16"
    remat: bool = True                 # per-layer recompute under grad
    scan_layers: bool = True           # reference only (the port loops)

    # citation for the config (paper/model card)
    source: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if not self.blocks:
            object.__setattr__(self, "blocks", self.default_blocks())
        assert len(self.blocks) == self.num_layers, (
            f"{self.name}: blocks length {len(self.blocks)} != L={self.num_layers}")
        for b in self.blocks:
            mixer, ffn = b.split("+")
            assert mixer in MIXERS and ffn in FFNS, f"bad block kind {b}"

    def default_blocks(self) -> Tuple[str, ...]:
        return ("attn+mlp",) * self.num_layers

    # --- derived ------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (the reference's sharding
        granule; kept so the embedding tables have the same shape)."""
        return int(math.ceil(self.vocab_size / 128) * 128)

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // 64

    @property
    def uses_moe(self) -> bool:
        return any(b.endswith("+moe") for b in self.blocks)

    @property
    def mixer_kinds(self) -> Tuple[str, ...]:
        return tuple(b.split("+")[0] for b in self.blocks)

    def param_count(self) -> int:
        """Analytic parameter count (approximate: embeddings + blocks)."""
        d = self.d_model
        n = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        for b in self.blocks:
            mixer, ffn = b.split("+")
            if mixer in ("attn", "swa"):
                n += d * self.num_heads * self.head_dim * 2  # q, o
                n += d * self.num_kv_heads * self.head_dim * 2  # k, v
            elif mixer == "mla":
                n += d * self.q_lora_rank
                n += self.q_lora_rank * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.num_heads * self.v_head_dim * d
            elif mixer == "mamba2":
                di = self.d_inner
                n += d * (2 * di + 2 * self.ssm_state_dim + self.ssm_num_heads)
                n += di * d
            elif mixer == "rwkv6":
                n += 6 * d * d  # r,k,v,g,o,w(lora) rough
            if ffn == "mlp":
                mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
            elif ffn == "moe":
                mult = 3
                n += self.num_experts * mult * d * self.moe_d_ff
                n += self.num_shared_experts * mult * d * self.moe_d_ff
                n += d * self.num_experts  # router
            elif ffn == "rwkv_cm":
                n += 2 * d * self.d_ff + d * d
        if self.shared_attn_every:
            n += 4 * d * self.num_heads * self.head_dim
        if self.is_encoder_decoder:
            # encoder blocks + cross attention in decoder
            enc = self.encoder_layers * (4 * d * self.num_heads * self.head_dim
                                         + 2 * d * self.d_ff)
            cross = self.num_layers * 4 * d * self.num_heads * self.head_dim
            n += enc + cross
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: only routed top-k + shared)."""
        if not self.uses_moe:
            return self.param_count()
        d = self.d_model
        n = self.param_count()
        moe_layers = sum(1 for b in self.blocks if b.endswith("+moe"))
        all_exp = self.num_experts * 3 * d * self.moe_d_ff
        act_exp = self.num_experts_per_tok * 3 * d * self.moe_d_ff
        n -= moe_layers * (all_exp - act_exp)
        return n

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.num_heads, 4))
        head_dim = max(16, min(self.head_dim, 64))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        nl = min(self.num_layers, 2)
        blocks = self.blocks[:1] + self.blocks[-1:] if nl == 2 else self.blocks[:nl]
        changes = dict(
            name=self.name + "-reduced",
            num_layers=nl,
            blocks=blocks,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 32) if self.encoder_seq_len else 0,
            num_patch_tokens=min(self.num_patch_tokens, 8) if self.num_patch_tokens else 0,
            window_size=min(self.window_size, 16) if self.window_size else 0,
            shared_attn_every=1 if self.shared_attn_every else 0,
            shared_attn_window=min(self.shared_attn_window, 16) if self.shared_attn_window else 0,
            ssm_state_dim=min(self.ssm_state_dim, 16) if self.ssm_state_dim else 0,
            ssm_head_dim=32 if self.ssm_state_dim else self.ssm_head_dim,
            dtype="float32",
            param_dtype="float32",
            remat=False,
            scan_layers=True,
        )
        if self.uses_moe:
            changes.update(
                num_experts=min(self.num_experts, 4),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                moe_d_ff=min(self.moe_d_ff, 128),
                first_k_dense=min(self.first_k_dense, 1),
                mtp_depth=min(self.mtp_depth, 1),
                # no-drop capacity so prefill+decode == forward exactly in
                # the smoke/equivalence tests
                moe_capacity_factor=float(min(self.num_experts, 4)),
            )
        if self.rope_kind == "mrope":
            half = head_dim // 2
            a = half // 4
            b = (half - a) // 2
            changes["mrope_sections"] = (a, b, half - a - b)
        if self.q_lora_rank:
            changes.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32,
                           qk_rope_dim=16, v_head_dim=32)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
