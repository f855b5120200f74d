"""The paper's logistic-regression benchmark model (Sec. 4, Table 2a) in the
port's API: the counterpart of the logreg part of ``benchmarks/models.py``.

The data has CoverType's shape (581,012 x 54) and is made from a seed with
numpy, as the JAX package makes it with ``jax.random``: features ~ N(0, 1),
``true_w ~ N(0, 0.5^2)``, ``y ~ Bernoulli(sigmoid(x @ true_w))``.  The HMM
and SKIM models wait for their slices.
"""
from __future__ import annotations

import numpy as np

from .. import core as pc
from ..core import dist


def covtype_data(seed=0, n=581_012, d=54):
    """numpy float32 ``{"x": (n, d), "y": (n,), "true_w": (d,)}``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    true_w = (rng.standard_normal(d, dtype=np.float32) * np.float32(0.5))
    logits = x @ true_w
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    y = (rng.random(n) < p).astype(np.float32)
    return {"x": x, "y": y, "true_w": true_w}


def logreg_model(x, y=None):
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y)


def logreg_model_glm(x, y=None):
    """Same model, opted into the fused GLM potential: the likelihood value
    and its gradient come from one ``ops.glm_potential_grad`` pass over x
    (verified affine at setup; falls back to the plain potential if not)."""
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
                     infer={"potential": "glm"})
