"""Bijective transforms and the ``biject_to`` constraint registry.

A :class:`Transform` ``t`` maps unconstrained space onto a support:
``x = t(u)``, ``u = t.inv(x)``, and ``t.log_abs_det_jacobian(u, x)`` gives
``log |det dx/du|``.  ``biject_to(constraint)`` dispatches a constraint to
the transform whose codomain is its support — the bridge that lets NUTS run
on constrained latents (see ``infer/util.py``).

The real-valued supports and the simplex (stick-breaking) are registered;
the other constraining bijections (exp, interval, lower-Cholesky) wait for
the distributions slice and raise a coded error until then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..errors import pending
from . import constraints

__all__ = ["Transform", "IdentityTransform", "StickBreakingTransform",
           "biject_to", "register_biject_to"]


class Transform:
    domain = constraints.real
    codomain = constraints.real

    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__ + "()"


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def inv(self, y):
        return y

    def log_abs_det_jacobian(self, x, y):
        return torch.zeros_like(x)


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

    def log_abs_det_jacobian(self, x, y):
        xo = x - self._offset(x)
        # dy_k/du_k = z_k (1 - z_k) * remainder_k, triangular Jacobian
        elem = (-F.softplus(xo) - F.softplus(-xo)
                + torch.log(torch.clamp(self._remainder(y), min=1e-30)))
        return torch.sum(elem, dim=-1)


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
register_biject_to(constraints._Simplex, lambda c: StickBreakingTransform())


def biject_to(constraint):
    """Return a bijection from unconstrained reals onto ``constraint``'s
    support.  Dispatch walks the constraint's MRO."""
    for klass in type(constraint).__mro__:
        factory = _REGISTRY.get(klass)
        if factory is not None:
            return factory(constraint)
    if isinstance(constraint, (constraints._Boolean,
                               constraints._IntegerInterval)):
        raise NotImplementedError(
            f"no biject_to bijection for constraint {constraint!r}: discrete "
            "supports have no bijection — observe those sites or "
            "marginalize them out.")
    raise pending(f"biject_to({constraint!r})", "distributions")
