"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596; hf]  12L d_model=1024 16H kv=16 d_ff=4096 vocab=256206.

12 encoder + 12 decoder layers; the speech frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings
(``src_embeds``).  Decode shapes run on the decoder with a cross-attention
cache; long_500k skipped (full quadratic attention)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    frontend="speech",
    frontend_len=0,
    max_seq=32768,
)
