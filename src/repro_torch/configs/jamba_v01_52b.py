"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]  32L d_model=4096 32H kv=8 d_ff=14336 vocab=65536.

Layer schedule: period 8, one attention layer at offset 4 (1:7 attn:mamba);
MoE replaces the MLP every 2 layers starting at layer 1.  Jamba v0.1's
Mamba-1 layers are realized with the Mamba-2 SSD formulation (MXU matmuls
instead of elementwise selective scans — see DESIGN.md hardware adaptation).
long_500k RUNS: SSM state is O(1) in sequence length."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe=True,
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    first_k_dense=1,            # offset: MoE on odd layers (jamba offset=1)
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    max_seq=262144,
)
