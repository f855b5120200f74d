"""Bijective transforms and the ``biject_to`` constraint registry.

A :class:`Transform` ``t`` maps unconstrained space onto a support:
``x = t(u)``, ``u = t.inv(x)``, and ``t.log_abs_det_jacobian(u, x)`` gives
``log |det dx/du|``.  ``biject_to(constraint)`` dispatches a constraint to
the transform whose codomain is its support — the bridge that lets NUTS run
on constrained latents (see ``infer/util.py``).

Only the real-valued supports are registered so far; the constraining
bijections (exp, interval, stick-breaking, lower-Cholesky) wait for the
distributions slice and raise a coded error until then.
"""
from __future__ import annotations

import torch

from ..errors import pending
from . import constraints

__all__ = ["Transform", "IdentityTransform", "biject_to", "register_biject_to"]


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


def biject_to(constraint):
    """Return a bijection from unconstrained reals onto ``constraint``'s
    support.  Dispatch walks the constraint's MRO."""
    for klass in type(constraint).__mro__:
        factory = _REGISTRY.get(klass)
        if factory is not None:
            return factory(constraint)
    if isinstance(constraint, constraints._Boolean):
        raise NotImplementedError(
            f"no biject_to bijection for constraint {constraint!r}: discrete "
            "supports have no bijection — observe those sites.")
    raise pending(f"biject_to({constraint!r})", "distributions")
