"""Bijective transforms and the ``biject_to`` constraint registry.

A :class:`Transform` ``t`` maps unconstrained space onto a support:
``x = t(u)``, ``u = t.inv(x)``, and ``t.log_abs_det_jacobian(u, x)`` gives
``log |det dx/du|``.  ``biject_to(constraint)`` dispatches a constraint to
the transform whose codomain is its support — the bridge that lets NUTS run
on constrained latents (see ``infer/util.py``).

``log_abs_det_jacobian`` is elementwise for scalar-event transforms and
reduced over the event dimension for vector/matrix-event ones
(stick-breaking, lower-Cholesky); callers sum whatever remains.  Every
continuous constraint is registered, as in the JAX package; a discrete
support raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import constraints

__all__ = ["Transform", "AffineTransform", "IdentityTransform",
           "ExpTransform", "SigmoidTransform", "IntervalTransform",
           "StickBreakingTransform", "LowerCholeskyTransform", "biject_to",
           "register_biject_to"]


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


class Transform:
    domain = constraints.real
    codomain = constraints.real

    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        raise NotImplementedError

    def forward_shape(self, shape):
        """The shape of ``self(x)`` for an ``x`` of ``shape``, computed
        without running the transform.  Elementwise transforms broadcast
        ``shape`` with their tensor parameters' shapes."""
        return tuple(torch.broadcast_shapes(
            tuple(shape), *(tuple(v.shape) for v in vars(self).values()
                            if isinstance(v, torch.Tensor))))

    def __repr__(self):
        return self.__class__.__name__ + "()"


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def inv(self, y):
        return y

    def log_abs_det_jacobian(self, x, y):
        return torch.zeros_like(x)


class AffineTransform(Transform):
    """``x -> loc + scale * x`` (elementwise; ``scale`` must be nonzero).
    ``TransformedDistribution(Normal(0, 1), AffineTransform(mu, tau))`` is
    ``Normal(mu, tau)`` with the location and scale split out as a
    transform that ``TransformReparam`` can peel off."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def __call__(self, x):
        return self.loc + self.scale * x

    def inv(self, y):
        return (y - self.loc) / self.scale

    def log_abs_det_jacobian(self, x, y):
        log_scale = torch.log(torch.abs(torch.as_tensor(
            self.scale, dtype=x.dtype, device=x.device)))
        return log_scale.broadcast_to(x.shape)


class ExpTransform(Transform):
    codomain = constraints.positive

    def __call__(self, x):
        return torch.exp(x)

    def inv(self, y):
        return torch.log(y)

    def log_abs_det_jacobian(self, x, y):
        return x


class SigmoidTransform(Transform):
    codomain = constraints.unit_interval

    def __call__(self, x):
        return torch.sigmoid(x)

    def inv(self, y):
        return torch.log(y) - torch.log1p(-y)

    def log_abs_det_jacobian(self, x, y):
        # log sigma(x) + log sigma(-x)
        return -F.softplus(x) - F.softplus(-x)


class IntervalTransform(Transform):
    """u -> lower + (upper - lower) * sigmoid(u)."""

    def __init__(self, lower_bound=0.0, upper_bound=1.0):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.codomain = constraints.interval(lower_bound, upper_bound)

    def __call__(self, x):
        width = self.upper_bound - self.lower_bound
        return self.lower_bound + width * torch.sigmoid(x)

    def inv(self, y):
        z = (y - self.lower_bound) / (self.upper_bound - self.lower_bound)
        return torch.log(z) - torch.log1p(-z)

    def log_abs_det_jacobian(self, x, y):
        width = self.upper_bound - self.lower_bound
        return _log(width) - F.softplus(x) - F.softplus(-x)


class StickBreakingTransform(Transform):
    """R^{K-1} -> K-simplex via the stick-breaking construction (Stan 10.7).

    ``z_k = sigmoid(u_k - log(K - k - 1))`` (0-indexed offset keeps u = 0 at
    the uniform simplex point), ``y_k = z_k * prod_{i<k}(1 - z_i)``.  The
    same formulas, clips and Jacobian as the JAX package's
    ``transforms.py:StickBreakingTransform``.
    """

    codomain = constraints.simplex

    @staticmethod
    def _offset(like):
        size = like.shape[-1]
        return torch.log(torch.arange(size, 0, -1, dtype=like.dtype,
                                      device=like.device))

    @staticmethod
    def _remainder(y):
        # remainder before stick k: 1 - sum_{i<k} y_i
        cs = torch.cumsum(y[..., :-1], dim=-1)
        return torch.cat([torch.ones_like(y[..., :1]), 1.0 - cs[..., :-1]],
                         dim=-1)

    def __call__(self, x):
        z = torch.sigmoid(x - self._offset(x))
        z1m_cumprod = torch.cumprod(1.0 - z, dim=-1)
        lead = torch.cat([torch.ones_like(x[..., :1]), z1m_cumprod[..., :-1]],
                         dim=-1)
        return torch.cat([z * lead, z1m_cumprod[..., -1:]], dim=-1)

    def inv(self, y):
        z = torch.clamp(y[..., :-1] / self._remainder(y), 1e-30, 1.0 - 1e-7)
        u = torch.log(z) - torch.log1p(-z)
        return u + self._offset(u)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)

    def log_abs_det_jacobian(self, x, y):
        xo = x - self._offset(x)
        # dy_k/du_k = z_k (1 - z_k) * remainder_k, triangular Jacobian
        elem = (-F.softplus(xo) - F.softplus(-xo)
                + torch.log(torch.clamp(self._remainder(y), min=1e-30)))
        return torch.sum(elem, dim=-1)


class LowerCholeskyTransform(Transform):
    """R^{d(d+1)/2} -> lower-triangular with positive (exp'd) diagonal.

    Layout: the first d(d-1)/2 entries fill the strict lower triangle
    row-major; the last d entries are the log-diagonal.
    """

    codomain = constraints.lower_cholesky

    @staticmethod
    def _matrix_dim(flat_size):
        d = int(round((math.sqrt(8.0 * flat_size + 1.0) - 1.0) / 2.0))
        if d * (d + 1) // 2 != flat_size:
            raise ValueError(
                f"size {flat_size} is not a triangular number d(d+1)/2")
        return d

    def forward_shape(self, shape):
        d = self._matrix_dim(shape[-1])
        return tuple(shape[:-1]) + (d, d)

    def __call__(self, x):
        d = self._matrix_dim(x.shape[-1])
        rows, cols = torch.tril_indices(d, d, -1, device=x.device)
        m = x.new_zeros(tuple(x.shape[:-1]) + (d, d))
        m[..., rows, cols] = x[..., :d * (d - 1) // 2]
        diag = torch.exp(x[..., d * (d - 1) // 2:])
        return m + torch.diag_embed(diag)

    def inv(self, y):
        d = y.shape[-1]
        rows, cols = torch.tril_indices(d, d, -1, device=y.device)
        log_diag = torch.log(torch.diagonal(y, dim1=-2, dim2=-1))
        return torch.cat([y[..., rows, cols], log_diag], dim=-1)

    def log_abs_det_jacobian(self, x, y):
        d = self._matrix_dim(x.shape[-1])
        return torch.sum(x[..., d * (d - 1) // 2:], dim=-1)


_REGISTRY = {}


def register_biject_to(constraint_type, factory=None):
    """Register ``factory(constraint) -> Transform`` for a constraint class.
    Usable as a decorator."""
    if factory is None:
        return lambda f: register_biject_to(constraint_type, f)
    _REGISTRY[constraint_type] = factory
    return factory


register_biject_to(constraints._Real, lambda c: IdentityTransform())
register_biject_to(constraints._RealVector, lambda c: IdentityTransform())
register_biject_to(constraints._Positive, lambda c: ExpTransform())
register_biject_to(constraints._UnitInterval,
                   lambda c: IntervalTransform(0.0, 1.0))
register_biject_to(
    constraints._Interval,
    lambda c: IntervalTransform(c.lower_bound, c.upper_bound))
register_biject_to(constraints._Simplex, lambda c: StickBreakingTransform())
register_biject_to(constraints._LowerCholesky,
                   lambda c: LowerCholeskyTransform())


def biject_to(constraint):
    """Return a bijection from unconstrained reals onto ``constraint``'s
    support.  Dispatch walks the constraint's MRO."""
    for klass in type(constraint).__mro__:
        factory = _REGISTRY.get(klass)
        if factory is not None:
            return factory(constraint)
    raise NotImplementedError(
        f"no biject_to bijection registered for constraint {constraint!r}; "
        "discrete supports (boolean/integer_interval) have no bijection — "
        "observe those sites or marginalize them out.")
