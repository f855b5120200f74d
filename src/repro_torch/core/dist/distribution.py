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
from . import transforms as transforms_mod


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


def _sum_rightmost(value, k):
    """Sum a tensor over its rightmost ``k`` dimensions (no-op for k == 0)."""
    return torch.sum(value, dim=tuple(range(-k, 0))) if k > 0 else value


def _chain_forward(transforms, x):
    for t in transforms:
        x = t(x)
    return x


class TransformedDistribution(Distribution):
    """Push a base distribution through a chain of bijective transforms.

    ``sample`` draws from ``base_distribution`` and applies the transforms
    left to right; ``log_prob`` inverts right to left and subtracts each
    transform's log-|det Jacobian| (change of variables).  Only elementwise,
    shape-preserving transforms are supported, which is what
    ``TransformReparam`` needs.  Batched transform parameters broadcast:
    the output shape is computed from the shapes alone
    (``Transform.forward_shape``, no compute and no draw) and the base
    distribution is expanded to it, so every output component gets an
    independent base draw.
    """

    arg_constraints: dict = {}

    def __init__(self, base_distribution, transforms):
        if isinstance(transforms, transforms_mod.Transform):
            transforms = [transforms]
        if not transforms:
            raise ValueError("TransformedDistribution needs >= 1 transform")
        self.transforms = list(transforms)
        out = tuple(base_distribution.shape())
        for t in self.transforms:
            out = t.forward_shape(out)
        event_dim = base_distribution.event_dim
        if out[len(out) - event_dim:] != tuple(base_distribution.event_shape):
            raise ValueError(
                f"transforms changed the event shape "
                f"{base_distribution.event_shape} -> {out}: only "
                "shape-preserving (elementwise, batch-broadcasting) "
                "transforms are supported")
        batch_shape = out[:len(out) - event_dim]
        if batch_shape != tuple(base_distribution.batch_shape):
            base_distribution = base_distribution.expand(batch_shape)
        self.base_dist = base_distribution
        super().__init__(batch_shape, base_distribution.event_shape)

    @property
    def support(self):
        # the final transform's codomain is the support only if every
        # earlier transform maps onto the final one's whole domain: a
        # constraining transform followed by e.g. an affine has a support
        # that cannot be represented, so fail at setup rather than hand
        # NUTS a wrong bijection
        base_support = self.base_dist.support
        if base_support is not None and not isinstance(
                base_support, (type(constraints.real),
                               type(constraints.real_vector))):
            raise NotImplementedError(
                f"support of a transformed {type(self.base_dist).__name__} "
                f"(base support {base_support!r}) is not representable: the "
                "transform image of a constrained base is not the final "
                "transform's codomain. Express the constraint as a transform "
                "from an unconstrained base instead")
        for t in self.transforms[:-1]:
            if not isinstance(t.codomain, type(constraints.real)):
                raise NotImplementedError(
                    f"support of a transform chain with a constraining "
                    f"non-final transform ({type(t).__name__}) is not "
                    "representable; put the constraining transform last, or "
                    "reparameterize the site (TransformReparam) so inference "
                    "sees only the base distribution")
        return self.transforms[-1].codomain

    def sample(self, generator=None, sample_shape=()):
        x = self.base_dist.sample(generator=generator,
                                  sample_shape=sample_shape)
        return _chain_forward(self.transforms, x)

    def log_prob(self, value):
        event_dim = self.event_dim
        # broadcast first, so the bookkeeping below sees every batch dim (a
        # scalar value against batched transform parameters would otherwise
        # have its per-component Jacobians counted as event dims and summed)
        value = torch.as_tensor(value)
        value = value.broadcast_to(torch.broadcast_shapes(
            value.shape, self.shape()))
        y = value
        log_det = 0.0
        for t in reversed(self.transforms):
            x = t.inv(y)
            ladj = t.log_abs_det_jacobian(x, y)
            # an elementwise ladj has value's ndim; transforms that reduced
            # their event dims already need no further reduction
            extra = ladj.dim() - (value.dim() - event_dim)
            log_det = log_det + _sum_rightmost(ladj, max(extra, 0))
            y = x
        return self.base_dist.log_prob(y) - log_det

    def expand(self, batch_shape):
        return ExpandedDistribution(self, tuple(batch_shape))
