"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), tied embeddings.
[arXiv:2403.08295; hf]  18L d_model=2048 8H kv=1 d_ff=16384 vocab=256000."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_act="geglu",
    tie_embeddings=True,
    max_seq=8192,
)
