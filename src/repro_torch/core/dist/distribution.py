"""Distribution base class plus the Independent / ExpandedDistribution
wrappers.

Design contract (consumed by ``primitives.py``, ``handlers.py`` and
``infer/``):

- ``d.batch_shape`` / ``d.event_shape``: batch dims broadcast, event dims
  are one draw.  ``d.log_prob(x)`` returns a ``batch_shape`` tensor.
- ``d.sample(generator, sample_shape)`` draws ``sample_shape + batch_shape
  + event_shape``; calling ``d(generator=..., sample_shape=...)`` aliases
  it.  Draws are made with the (CPU) generator and moved to the device of
  the parameters.
- ``d.support`` is a callable constraint and the dispatch key for
  ``biject_to``.
- ``d.expand(shape)`` broadcasts batch dims (plates call this);
  ``d.to_event(n)`` reinterprets the rightmost ``n`` batch dims as event
  dims.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import constraints


def shape_of(value) -> tuple:
    return tuple(value.shape) if hasattr(value, "shape") else ()


def param_like(value):
    """(dtype, device) a draw for a parameter ``value`` should have."""
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return value.dtype, value.device
    if isinstance(value, torch.Tensor):
        return torch.get_default_dtype(), value.device
    return torch.get_default_dtype(), torch.device("cpu")


class Distribution:
    # parameter name -> constraint; the constraint's event_dim tells
    # ``expand`` which trailing dims of a parameter belong to the event
    arg_constraints: dict = {}
    support: Optional[constraints.Constraint] = None
    has_enumerate_support: bool = False

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    @property
    def event_dim(self):
        return len(self._event_shape)

    def shape(self, sample_shape=()):
        return tuple(sample_shape) + self._batch_shape + self._event_shape

    def sample(self, generator=None, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def enumerate_support(self, expand=True):
        """All values of a finite support, stacked along a fresh leftmost dim.

        Returns an integer tensor of shape ``(K,) + batch_shape`` (``expand=
        True``) or ``(K,) + (1,) * len(batch_shape)`` (``expand=False``, the
        broadcast-ready form the ``enum`` handler installs).  Only defined
        when ``has_enumerate_support``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no enumerate_support: only discrete "
            "distributions with finite support can be enumerated")

    def __call__(self, *args, generator=None, sample_shape=(), **kwargs):
        return self.sample(generator=generator, sample_shape=sample_shape)

    def expand(self, batch_shape):
        """Broadcast to ``batch_shape`` by broadcasting every parameter
        (draws along expanded dims are independent)."""
        batch_shape = tuple(batch_shape)
        if batch_shape == self._batch_shape:
            return self
        new_params = {}
        for name, constraint in self.arg_constraints.items():
            value = getattr(self, name)
            if value is None:
                new_params[name] = None
                continue
            shape = shape_of(value)
            event_ndim = constraint.event_dim
            event_part = shape[len(shape) - event_ndim:] if event_ndim else ()
            new_params[name] = torch.as_tensor(value).broadcast_to(
                batch_shape + event_part)
        return type(self)(**new_params)

    def to_event(self, reinterpreted_batch_ndims=None):
        if reinterpreted_batch_ndims is None:
            reinterpreted_batch_ndims = len(self._batch_shape)
        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(self, reinterpreted_batch_ndims)

    def __repr__(self):
        params = ", ".join(f"{k}={getattr(self, k)!r}"
                           for k in self.arg_constraints
                           if getattr(self, k) is not None)
        return f"{type(self).__name__}({params})"


class Independent(Distribution):
    """Reinterpret the rightmost ``reinterpreted_batch_ndims`` batch dims of
    ``base_dist`` as event dims: ``log_prob`` sums over them."""

    def __init__(self, base_dist, reinterpreted_batch_ndims):
        if reinterpreted_batch_ndims > len(base_dist.batch_shape):
            raise ValueError(
                f"cannot reinterpret {reinterpreted_batch_ndims} batch dims "
                f"of a distribution with batch_shape {base_dist.batch_shape}")
        self.base_dist = base_dist
        self.reinterpreted_batch_ndims = reinterpreted_batch_ndims
        shape = base_dist.batch_shape + base_dist.event_shape
        split = len(base_dist.batch_shape) - reinterpreted_batch_ndims
        super().__init__(shape[:split], shape[split:])

    @property
    def support(self):
        return self.base_dist.support

    def sample(self, generator=None, sample_shape=()):
        return self.base_dist.sample(generator=generator,
                                     sample_shape=sample_shape)

    def log_prob(self, value):
        log_prob = self.base_dist.log_prob(value)
        dims = tuple(range(-self.reinterpreted_batch_ndims, 0))
        return torch.sum(log_prob, dim=dims)

    def expand(self, batch_shape):
        batch_shape = tuple(batch_shape)
        base_batch = self.base_dist.batch_shape
        reinterpreted = base_batch[len(base_batch)
                                   - self.reinterpreted_batch_ndims:]
        return Independent(self.base_dist.expand(batch_shape + reinterpreted),
                           self.reinterpreted_batch_ndims)

    def to_event(self, reinterpreted_batch_ndims=None):
        if reinterpreted_batch_ndims is None:
            reinterpreted_batch_ndims = len(self.batch_shape)
        if reinterpreted_batch_ndims == 0:
            return self
        return Independent(
            self.base_dist,
            self.reinterpreted_batch_ndims + reinterpreted_batch_ndims)


class ExpandedDistribution(Distribution):
    """Generic batch-broadcast wrapper for distributions whose parameters
    cannot simply be broadcast.  Expanded dims draw independent samples."""

    def __init__(self, base_dist, batch_shape=()):
        batch_shape = tuple(batch_shape)
        if torch.broadcast_shapes(batch_shape,
                                  base_dist.batch_shape) != batch_shape:
            raise ValueError(
                f"cannot expand batch_shape {base_dist.batch_shape} "
                f"to {batch_shape}")
        self.base_dist = base_dist
        super().__init__(batch_shape, base_dist.event_shape)

    @property
    def support(self):
        return self.base_dist.support

    @property
    def has_enumerate_support(self):
        return self.base_dist.has_enumerate_support

    def enumerate_support(self, expand=True):
        values = self.base_dist.enumerate_support(expand=False)
        values = values.reshape(values.shape[:1]
                                + (1,) * len(self._batch_shape))
        if expand:
            values = values.broadcast_to(values.shape[:1] + self._batch_shape)
        return values

    def sample(self, generator=None, sample_shape=()):
        lead = self._batch_shape[:len(self._batch_shape)
                                 - len(self.base_dist.batch_shape)]
        value = self.base_dist.sample(generator=generator,
                                      sample_shape=tuple(sample_shape) + lead)
        return value.broadcast_to(self.shape(sample_shape))

    def log_prob(self, value):
        log_prob = self.base_dist.log_prob(value)
        shape = torch.broadcast_shapes(shape_of(log_prob), self._batch_shape)
        return log_prob.broadcast_to(shape)

    def expand(self, batch_shape):
        return ExpandedDistribution(self.base_dist, tuple(batch_shape))
