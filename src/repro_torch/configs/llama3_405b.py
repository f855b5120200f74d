"""llama3-405b [dense] — GQA kv=8, 128k vocab.
[arXiv:2407.21783; unverified]  126L d_model=16384 128H kv=8 d_ff=53248
vocab=128256.  long_500k skipped: pure full quadratic attention (DESIGN.md
§Arch-applicability)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_base=500000.0,
    max_seq=8192,
)
