"""Distribution library: the density layer under the effect-handler stack.

A :class:`~repro_torch.core.dist.distribution.Distribution` base with
batch/event-shape semantics, ``expand``/``to_event`` wrappers, callable
constraint supports and a ``biject_to`` registry.  This package stays free
of intra-``repro_torch.core`` imports other than ``errors``.
"""
from . import constraints, transforms
from .continuous import Delta, Dirichlet, Normal
from .discrete import Bernoulli, Categorical
from .distribution import Distribution, ExpandedDistribution, Independent
from .transforms import biject_to

__all__ = ["Bernoulli", "Categorical", "Delta", "Dirichlet", "Distribution",
           "ExpandedDistribution", "Independent", "Normal", "biject_to",
           "constraints", "transforms"]
