"""Distribution library: the density layer under the effect-handler stack.

A :class:`~repro_torch.core.dist.distribution.Distribution` base with
batch/event-shape semantics, ``expand``/``to_event`` wrappers, callable
constraint supports and a ``biject_to`` registry.  This package stays free
of intra-``repro_torch.core`` imports other than ``errors``.
"""
from . import constraints, transforms
from .continuous import (Beta, Cauchy, Delta, Dirichlet, Exponential, Gamma,
                         HalfCauchy, HalfNormal, InverseGamma, LogNormal,
                         MultivariateNormal, Normal, StudentT)
from .discrete import Bernoulli, Categorical, DiscreteUniform
from .distribution import (Distribution, ExpandedDistribution, Independent,
                           TransformedDistribution)
from .transforms import AffineTransform, biject_to

__all__ = ["AffineTransform", "Bernoulli", "Beta", "Categorical", "Cauchy",
           "Delta", "Dirichlet", "DiscreteUniform", "Distribution",
           "ExpandedDistribution", "Exponential", "Gamma", "HalfCauchy",
           "HalfNormal", "Independent", "InverseGamma", "LogNormal",
           "MultivariateNormal", "Normal", "StudentT",
           "TransformedDistribution", "biject_to", "constraints",
           "transforms"]
