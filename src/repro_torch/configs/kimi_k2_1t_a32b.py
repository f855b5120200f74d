"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H d_ff(expert)=2048
vocab=163840, MoE 384e top-8.

K2 keeps the DeepSeek-V3 block (MLA attention + sigmoid-routed MoE) with 64
query heads and 384 experts; the pool's "GQA kv=8" annotation corresponds to
the MLA kv compression (one shared latent).  384 experts pad to 512 for the
256-way EP mesh (phantom experts are never routed; see DESIGN.md §6)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=64,
    d_ff=18432,
    vocab_size=163840,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    num_experts=384,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=1,
    router_type="sigmoid",
    mtp=True,
    max_seq=4096,
)
