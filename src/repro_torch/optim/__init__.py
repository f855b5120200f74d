"""Functional optimizers (the port of ``repro/optim``): ``init``/``update``
pairs over nested dicts of tensors.  Gradient compression (``compression.py``
of the JAX package) waits for the multi-GPU item of the port (ROADMAP.md)."""
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

__all__ = [
    "AdafactorState", "AdamState", "GradientTransformation", "adafactor",
    "adam", "adamw", "apply_updates", "chain", "clip_by_global_norm",
    "global_norm", "scale", "scale_by_schedule", "sgd", "tree_leaves",
    "tree_map", "warmup_cosine",
]
