"""pixtral-12b [vlm] — mistral-nemo backbone + pixtral-ViT frontend.
[hf:mistralai/Pixtral-12B-2409; unverified]  40L d_model=5120 32H kv=8
d_ff=14336 vocab=131072.

Backbone is exact; the vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings for the first
``frontend_len`` positions (the launcher's batch carries ``patch_embeds``)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_base=1000000.0,
    frontend="vision",
    frontend_len=1024,
    max_seq=32768,
)
