"""Continuous distributions.  ``log_prob`` is the bare closed form (no
support masking): inference only evaluates it inside the support via
``biject_to``.  ``Normal``, ``Dirichlet`` and ``Delta`` are ported; the
other continuous distributions of the JAX package wait for the
distributions slice."""
from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import (Distribution, ExpandedDistribution, param_like,
                           shape_of)

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


class Dirichlet(Distribution):
    arg_constraints = {"concentration": constraints.positive_vector}
    support = constraints.simplex

    def __init__(self, concentration):
        self.concentration = concentration
        shape = shape_of(concentration)
        if len(shape) < 1:
            raise ValueError("Dirichlet concentration must be at least 1-d")
        super().__init__(shape[:-1], shape[-1:])

    def sample(self, generator=None, sample_shape=()):
        """Normalized standard-gamma draws, made on the CPU from
        ``generator`` (never the global generator) and moved to the
        concentration's device."""
        conc = torch.as_tensor(self.concentration)
        dtype, device = param_like(conc)
        shape = self.shape(sample_shape)
        gammas = torch._standard_gamma(
            conc.detach().to("cpu", dtype).broadcast_to(shape).contiguous(),
            generator=generator)
        x = gammas.clamp(min=torch.finfo(dtype).tiny)
        return (x / x.sum(-1, keepdim=True)).to(device)

    def log_prob(self, value):
        conc = torch.as_tensor(self.concentration)
        normalizer = torch.lgamma(conc.sum(-1)) - torch.lgamma(conc).sum(-1)
        return torch.sum((conc - 1.0) * torch.log(value), dim=-1) + normalizer


class Delta(Distribution):
    """Point mass at ``v``, optionally carrying an extra ``log_density`` term
    (used to book-keep marginalized factors in models)."""

    arg_constraints = {"v": constraints.real, "log_density": constraints.real}
    support = constraints.real

    def __init__(self, v=0.0, log_density=0.0, event_dim=0):
        if event_dim > len(shape_of(v)):
            raise ValueError("event_dim exceeds ndim of the Delta value")
        self.v = v
        self.log_density = log_density
        shape = shape_of(v)
        split = len(shape) - event_dim
        super().__init__(shape[:split], shape[split:])

    def sample(self, generator=None, sample_shape=()):
        return torch.as_tensor(self.v).broadcast_to(self.shape(sample_shape))

    def log_prob(self, value):
        value = torch.as_tensor(value)
        dtype = value.dtype if value.is_floating_point() \
            else torch.get_default_dtype()
        log_prob = torch.where(value == self.v, 0.0, -math.inf).to(dtype)
        log_prob = log_prob + self.log_density
        dims = tuple(range(-len(self.event_shape), 0))
        return torch.sum(log_prob, dim=dims) if dims else log_prob

    def expand(self, batch_shape):
        return ExpandedDistribution(self, tuple(batch_shape))
