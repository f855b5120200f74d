"""Support constraints for distributions.

A :class:`Constraint` is a callable predicate: ``constraint(x)`` returns a
boolean tensor saying whether ``x`` lies in the support, with the trailing
``event_dim`` dimensions reduced away.  Constraints double as dispatch keys
for :func:`repro_torch.core.dist.transforms.biject_to`.

``positive``, ``positive_vector`` and ``unit_interval`` are here as
parameter constraints (they tell ``expand`` each parameter's event rank);
their bijections wait for the distributions slice.  ``simplex`` is both a
parameter constraint and a support (``Dirichlet``), and ``integer_interval``
the support of ``Categorical``.
"""
from __future__ import annotations

import torch

__all__ = ["Constraint", "boolean", "integer_interval", "positive",
           "positive_vector", "real", "real_vector", "simplex",
           "unit_interval"]


class Constraint:
    """Base class.  ``event_dim`` is the number of trailing dimensions that
    form one constrained event."""

    event_dim = 0

    def __call__(self, x):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__.lstrip("_")


class _Real(Constraint):
    def __call__(self, x):
        return torch.isfinite(torch.as_tensor(x))


class _RealVector(Constraint):
    event_dim = 1

    def __call__(self, x):
        return torch.all(torch.isfinite(x), dim=-1)


class _Positive(Constraint):
    def __call__(self, x):
        return torch.as_tensor(x) > 0


class _PositiveVector(_Positive):
    event_dim = 1

    def __call__(self, x):
        return torch.all(torch.as_tensor(x) > 0, dim=-1)


class _UnitInterval(Constraint):
    def __call__(self, x):
        x = torch.as_tensor(x)
        return (x >= 0) & (x <= 1)


class _Boolean(Constraint):
    def __call__(self, x):
        x = torch.as_tensor(x)
        return (x == 0) | (x == 1)


class _IntegerInterval(Constraint):
    def __init__(self, lower_bound, upper_bound):
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def __call__(self, x):
        x = torch.as_tensor(x)
        ok = (x >= self.lower_bound) & (x <= self.upper_bound)
        if x.is_floating_point():
            ok = ok & (x == torch.floor(x))
        return ok


class _Simplex(Constraint):
    event_dim = 1

    def __call__(self, x):
        x = torch.as_tensor(x)
        return torch.all(x >= 0, dim=-1) & (torch.abs(x.sum(-1) - 1.0) < 1e-5)


real = _Real()
real_vector = _RealVector()
positive = _Positive()
unit_interval = _UnitInterval()
boolean = _Boolean()
positive_vector = _PositiveVector()
simplex = _Simplex()
integer_interval = _IntegerInterval
