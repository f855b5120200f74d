"""Functional optimizers (the port of ``repro/optim``): ``init``/``update``
pairs over nested dicts of tensors (DTensors on a mesh too), and the int8
gradient compression with error feedback (``compression``)."""
from .optimizers import (
    AdafactorState,
    AdamState,
    GradientTransformation,
    adafactor,
    adam,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
    scale,
    scale_by_schedule,
    sgd,
    tree_leaves,
    tree_map,
    warmup_cosine,
)
from .compression import int8_compress_decompress, error_feedback_compress

__all__ = [
    "AdafactorState", "AdamState", "GradientTransformation", "adafactor",
    "adam", "adamw", "apply_updates", "chain", "clip_by_global_norm",
    "global_norm", "scale", "scale_by_schedule", "sgd", "tree_leaves",
    "tree_map", "warmup_cosine", "int8_compress_decompress",
    "error_feedback_compress",
]
