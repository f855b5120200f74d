"""Discrete distributions.  ``Bernoulli`` and ``Categorical`` accept either
``probs`` or ``logits`` (exactly one) and compute ``log_prob`` in logit
space, so densities stay finite for extreme logits.  Both have finite
supports and implement ``enumerate_support``, which is what lets the
enumeration subsystem (:mod:`repro_torch.core.infer.enum`) marginalize them
exactly instead of needing a ``biject_to`` bijection; so does
``DiscreteUniform``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints
from .distribution import (Distribution, ExpandedDistribution, param_like,
                           shape_of)


def _clip_probs(probs):
    eps = torch.finfo(probs.dtype if probs.is_floating_point()
                      else torch.float32).eps
    return torch.clamp(probs, eps, 1.0 - eps)


def _device(value):
    return value.device if isinstance(value, torch.Tensor) \
        else torch.device("cpu")


def _enum_values(num, batch_shape, expand, device):
    """(K,) + (1,)*len(batch_shape) int64 support stack on ``device``,
    broadcast on request — the shared tail of every ``enumerate_support``
    (int64 where the JAX package has int32: the index type of torch)."""
    values = torch.arange(num, dtype=torch.long, device=device)
    values = values.reshape((num,) + (1,) * len(batch_shape))
    if expand:
        values = values.broadcast_to((num,) + tuple(batch_shape))
    return values


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

    def enumerate_support(self, expand=True):
        param = self.probs if self.probs is not None else self.logits
        return _enum_values(2, self.batch_shape, expand, _device(param))


class Categorical(Distribution):
    arg_constraints = {"probs": constraints.simplex,
                       "logits": constraints.real_vector}
    has_enumerate_support = True

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("provide exactly one of probs, logits")
        self.probs = probs
        self.logits = logits
        param = probs if probs is not None else logits
        shape = shape_of(param)
        if len(shape) < 1:
            raise ValueError("Categorical parameters must be at least 1-d")
        self._num_categories = shape[-1]
        super().__init__(shape[:-1])

    @property
    def support(self):
        return constraints.integer_interval(0, self._num_categories - 1)

    def _logits(self):
        if self.logits is not None:
            return self.logits
        return torch.log(_clip_probs(self.probs))

    def sample(self, generator=None, sample_shape=()):
        """Gumbel-max on the logits, with the uniforms drawn on the CPU
        from ``generator`` and moved to the parameters' device."""
        logits = self._logits()
        shape = self.shape(sample_shape) + (self._num_categories,)
        u = torch.rand(shape, generator=generator, dtype=logits.dtype)
        tiny = torch.finfo(logits.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
        return torch.argmax(logits + gumbel.to(logits.device), dim=-1)

    def log_prob(self, value):
        log_pmf = torch.log_softmax(self._logits(), dim=-1)
        value = torch.as_tensor(value, device=log_pmf.device).long()
        batch = tuple(value.shape)
        if batch != self.batch_shape:
            batch = tuple(torch.broadcast_shapes(batch, self.batch_shape))
        log_pmf = log_pmf.broadcast_to(batch + (self._num_categories,))
        value = value.broadcast_to(batch)
        return torch.gather(log_pmf, -1, value[..., None])[..., 0]

    def enumerate_support(self, expand=True):
        param = self.probs if self.probs is not None else self.logits
        return _enum_values(self._num_categories, self.batch_shape, expand,
                            _device(param))


class DiscreteUniform(Distribution):
    """Uniform over the integers ``low .. high`` (both inclusive).  ``low``
    and ``high`` are Python ints, so the support size is known without a
    read for ``enumerate_support``."""

    arg_constraints: dict = {}
    has_enumerate_support = True

    def __init__(self, low=0, high=1):
        low, high = int(low), int(high)
        if high < low:
            raise ValueError(
                f"DiscreteUniform needs low <= high, got [{low}, {high}]")
        self.low = low
        self.high = high
        super().__init__(())

    @property
    def support(self):
        return constraints.integer_interval(self.low, self.high)

    def expand(self, batch_shape):
        # no parameter to broadcast: expanded dims draw independently
        return ExpandedDistribution(self, tuple(batch_shape))

    def sample(self, generator=None, sample_shape=()):
        return torch.randint(self.low, self.high + 1,
                             self.shape(sample_shape), generator=generator,
                             dtype=torch.int32)

    def log_prob(self, value):
        value = torch.as_tensor(value)
        n = self.high - self.low + 1
        lp = torch.full(value.shape, -math.log(n),
                        dtype=torch.get_default_dtype(), device=value.device)
        return torch.where(self.support(value), lp, -math.inf)

    def enumerate_support(self, expand=True):
        return _enum_values(self.high - self.low + 1, self.batch_shape,
                            expand, torch.device("cpu")) + self.low
