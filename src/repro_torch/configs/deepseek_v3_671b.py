"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.

The assignment's d_ff=2048 is the per-expert hidden dim; the dense-prefix
layers (first_k_dense=3 per the paper) use the paper's dense d_ff=18432.
Sigmoid routing with the aux-free balancing bias (updated from load stats in
train_step, not by gradients)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    router_type="sigmoid",
    mtp=True,
    max_seq=4096,
)
