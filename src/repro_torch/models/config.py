"""Unified model configuration covering every assigned architecture family
(a copy of the JAX package's ``models/config.py``, with a torch dtype in
place of ``jnp_dtype``).

One dataclass describes dense / MoE / hybrid (attn+SSM) / SSM / VLM / audio
transformers; family-specific fields are simply unused elsewhere.  Configs are
plain data — building the params tree and the forward function from a config
is the job of :mod:`repro_torch.models.zoo`, which builds the dense GQA
families so far.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention flavour ---------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla  (mha == gqa with kv == heads)
    qk_norm: bool = False           # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False          # qwen1.5-style bias on qkv projections
    rope_base: float = 10000.0
    # MLA (deepseek-v3 / kimi-k2) dims
    q_lora_rank: int = 0            # 0 => full-rank q projection
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_absorbed_decode: bool = False  # absorbed-matmul decode (§Perf):
    #   scores against the compressed latent directly; k/v never expand

    # --- MLP / MoE -----------------------------------------------------------
    mlp_act: str = "swiglu"         # swiglu | geglu
    moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    first_k_dense: int = 0          # deepseek: first k layers use dense MLP
    moe_layer_period: int = 1       # jamba: MoE every `period` layers
    router_type: str = "softmax"    # softmax | sigmoid (deepseek-v3)
    aux_loss_weight: float = 0.001
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba2) / hybrid (jamba) ----------------------------------------
    ssm_state: int = 0              # N: state size per head
    ssm_head_dim: int = 64          # P: channels per SSD head
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 256            # SSD chunk length
    attn_layer_period: int = 0      # jamba: 1 attn layer per `period` (rest SSM)
    attn_layer_offset: int = 0      # position of the attn layer in the period

    # --- encoder-decoder (seamless-m4t) ---------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    norm_style: str = "rmsnorm"     # rmsnorm | layernorm

    # --- multimodal frontend stubs --------------------------------------------
    frontend: Optional[str] = None  # vision | speech  (precomputed embeddings)
    frontend_len: int = 0           # number of prefix embedding positions

    # --- extras ----------------------------------------------------------------
    mtp: bool = False               # deepseek multi-token-prediction head
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    kv_cache_int8: bool = False     # per-(pos, head) symmetric int8 KV
    #   cache (~1.9x HBM saving at decode; see EXPERIMENTS.md §Perf)
    max_seq: int = 8192
    z_loss_weight: float = 1e-4

    # ---------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def q_head_dim(self) -> int:
        """Per-head q/k dim actually used in attention score matmuls."""
        if self.attn_type == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid (jamba) layer schedule: 1 attention layer per period."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe:
            return False
        if i < self.first_k_dense:
            return False
        return (i - self.first_k_dense) % self.moe_layer_period == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, global_batch) workload cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family != "hybrid"
                       else max(cfg.attn_layer_period, 4)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=32,
        d_ff=256,
        vocab_size=256,
        max_seq=128,
        dtype="float32",
    )
    if cfg.attn_type == "mla":
        base.update(q_lora_rank=(64 if cfg.q_lora_rank else 0), kv_lora_rank=32,
                    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
    if cfg.moe:
        base.update(num_experts=min(cfg.num_experts, 8),
                    num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
                    moe_d_ff=64,
                    num_shared_experts=cfg.num_shared_experts,
                    first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.family in ("ssm", "hybrid"):
        base.update(ssm_state=min(cfg.ssm_state, 16) or 16, ssm_head_dim=16,
                    ssm_chunk=32, d_model=128)
    if cfg.is_encoder_decoder:
        base.update(num_encoder_layers=2, num_layers=2)
    if cfg.frontend:
        base.update(frontend_len=min(cfg.frontend_len, 16))
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
