"""Support constraints for distributions.

A :class:`Constraint` is a callable predicate: ``constraint(x)`` returns a
boolean tensor saying whether ``x`` lies in the support, with the trailing
``event_dim`` dimensions reduced away.  Constraints double as dispatch keys
for :func:`repro_torch.core.dist.transforms.biject_to`.

``positive`` and ``unit_interval`` are here as parameter constraints (they
tell ``expand`` each parameter's event rank); their bijections wait for the
distributions slice.
"""
from __future__ import annotations

import torch

__all__ = ["Constraint", "boolean", "positive", "real", "real_vector",
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


class _UnitInterval(Constraint):
    def __call__(self, x):
        x = torch.as_tensor(x)
        return (x >= 0) & (x <= 1)


class _Boolean(Constraint):
    def __call__(self, x):
        x = torch.as_tensor(x)
        return (x == 0) | (x == 1)


real = _Real()
real_vector = _RealVector()
positive = _Positive()
unit_interval = _UnitInterval()
boolean = _Boolean()
