"""Discrete distributions.  ``Bernoulli`` accepts either ``probs`` or
``logits`` (exactly one) and computes ``log_prob`` in logit space, so
densities stay finite for extreme logits.  Categorical and DiscreteUniform
wait for the distributions slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import constraints
from .distribution import Distribution, param_like, shape_of


def _clip_probs(probs):
    eps = torch.finfo(probs.dtype if probs.is_floating_point()
                      else torch.float32).eps
    return torch.clamp(probs, eps, 1.0 - eps)


class Bernoulli(Distribution):
    arg_constraints = {"probs": constraints.unit_interval,
                       "logits": constraints.real}
    support = constraints.boolean
    has_enumerate_support = True

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("provide exactly one of probs, logits")
        self.probs = probs
        self.logits = logits
        param = probs if probs is not None else logits
        super().__init__(shape_of(param))

    def _logits(self):
        if self.logits is not None:
            return self.logits
        p = _clip_probs(torch.as_tensor(self.probs))
        return torch.log(p) - torch.log1p(-p)

    def _probs(self):
        if self.probs is not None:
            return torch.as_tensor(self.probs)
        return torch.sigmoid(torch.as_tensor(self.logits))

    def sample(self, generator=None, sample_shape=()):
        probs = self._probs()
        dtype, device = param_like(probs)
        u = torch.rand(self.shape(sample_shape), generator=generator,
                       dtype=dtype).to(device)
        return (u < probs).to(torch.int32)

    def log_prob(self, value):
        logits = self._logits()
        return value * logits - F.softplus(logits)
