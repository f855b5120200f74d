"""qwen3-8b [dense] — qk_norm (per-head RMSNorm), GQA kv=8.
[hf:Qwen/Qwen3-8B; hf]  36L d_model=4096 32H kv=8 d_ff=12288 vocab=151936."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_base=1000000.0,
    max_seq=32768,
)
