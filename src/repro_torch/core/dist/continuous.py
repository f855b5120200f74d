"""Continuous distributions.  ``log_prob`` is the bare closed form (no
support masking): inference only evaluates it inside the support via
``biject_to``.  The other continuous distributions of the JAX package wait
for the distributions slice."""
from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import Distribution, param_like, shape_of

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


class Normal(Distribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale
        super().__init__(torch.broadcast_shapes(shape_of(loc), shape_of(scale)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = param_like(self.loc)
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          dtype=dtype).to(device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - _HALF_LOG_2PI
