"""Reparameterizers for the :class:`~repro_torch.core.handlers.reparam`
handler.

A reparameterizer rewrites one latent sample site into auxiliary sites plus
deterministic transforms: the joint density stays the same, the geometry the
sampler sees changes.  The canonical case is the non-centered form of a
hierarchical model: ``theta ~ Normal(mu, tau)`` becomes ``theta_decentered ~
Normal(0, 1)`` with ``theta = mu + tau * theta_decentered``, which NUTS
crosses without the step-size trouble of the centered funnel.

The handler calls a strategy as ``new_fn, value = strategy(name, fn, obs)``,
where ``fn`` is the site's (possibly plate-expanded) distribution and ``obs``
the observed value or None.  ``(None, value)`` turns the site into a
deterministic function of the auxiliaries the strategy sampled; ``(new_fn,
None)`` only swaps the site's distribution.  Auxiliary sample statements
re-enter the handler stack like hand-written sites: they are seeded, traced,
substituted and plate-expanded, so reparameterized models run unchanged
under ``Predictive`` and MCMC.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import primitives
from .dist.distribution import (Distribution, ExpandedDistribution,
                                Independent, TransformedDistribution,
                                shape_of)

__all__ = ["Reparam", "TransformReparam", "LocScaleReparam"]


def _unwrap(fn):
    """Peel the ``Independent``/``ExpandedDistribution`` wrappers
    (``.to_event`` and plate expansion add them), remembering the draw
    shape and event dim so :func:`_wrap` can rebuild them around a
    replacement base distribution."""
    shape = fn.shape()
    event_dim = fn.event_dim
    while isinstance(fn, (Independent, ExpandedDistribution)):
        fn = fn.base_dist
    return fn, shape, event_dim


def _wrap(fn, shape, event_dim):
    """Inverse of :func:`_unwrap`: expand ``fn`` so one draw has ``shape``,
    then reinterpret trailing dims up to ``event_dim``."""
    batch_shape = tuple(shape[:len(shape) - fn.event_dim])
    if batch_shape != tuple(fn.batch_shape):
        fn = fn.expand(batch_shape)
    extra = event_dim - fn.event_dim
    if extra > 0:
        fn = fn.to_event(extra)
    return fn


class Reparam:
    """Base class: a callable ``(name, fn, obs) -> (new_fn, value)``."""

    def __call__(self, name: str, fn: Distribution, obs
                 ) -> Tuple[Optional[Distribution], Optional[torch.Tensor]]:
        raise NotImplementedError


class TransformReparam(Reparam):
    """Split a :class:`~repro_torch.core.dist.TransformedDistribution` site
    into a sample of its base distribution (at ``f"{name}_base"``) and the
    deterministic transform chain: the sampler then sees the base draw,
    whatever geometry the transform parameters make."""

    def __call__(self, name, fn, obs):
        if obs is not None:
            raise ValueError(
                f"TransformReparam cannot reparameterize observed site '{name}'")
        fn, shape, event_dim = _unwrap(fn)
        if not isinstance(fn, TransformedDistribution):
            raise ValueError(
                f"TransformReparam expects a TransformedDistribution at site "
                f"'{name}', got {type(fn).__name__}")
        base = _wrap(fn.base_dist, shape, event_dim)
        x = primitives.sample(f"{name}_base", base,
                              infer={"reparam_auxiliary": True})
        for t in fn.transforms:
            x = t(x)
        return None, x


class LocScaleReparam(Reparam):
    """Centered (1.0) to non-centered (0.0) reparameterization of a
    loc-scale family site (Normal, Cauchy, StudentT, ...).

    For centering weight ``c`` the auxiliary site ``f"{name}_decentered"``
    draws from ``type(fn)(loc * c, scale ** c, **shape_params)`` and the
    original site becomes the deterministic

        ``value = loc + scale ** (1 - c) * (decentered - c * loc)``

    so ``c = 1`` changes nothing and ``c = 0`` (the default) is the
    non-centered ``loc + scale * eps`` with ``eps ~ type(fn)(0, 1)``.  With
    ``centered=None`` the weight is a ``param`` site (initial value 0.5),
    unconstrained.  ``shape_params`` names the other parameters to forward
    as they are (e.g. ``("df",)`` for StudentT).
    """

    def __init__(self, centered: Optional[float] = 0.0, shape_params=()):
        if centered is not None and not 0.0 <= float(centered) <= 1.0:
            raise ValueError(f"centered must be in [0, 1], got {centered}")
        self.centered = centered
        self.shape_params = tuple(shape_params)

    def __call__(self, name, fn, obs):
        if obs is not None:
            raise ValueError(
                f"LocScaleReparam cannot reparameterize observed site '{name}'")
        centered = self.centered
        if centered is not None and float(centered) == 1.0:
            return fn, None
        fn, shape, event_dim = _unwrap(fn)
        if not (hasattr(fn, "loc") and hasattr(fn, "scale")):
            raise ValueError(
                f"LocScaleReparam expects a loc-scale distribution at site "
                f"'{name}', got {type(fn).__name__}")
        loc, scale = fn.loc, fn.scale
        if centered is None:
            init = torch.full(torch.broadcast_shapes(shape_of(loc),
                                                     shape_of(scale)), 0.5)
            centered = primitives.param(f"{name}_centered", init)
        params = {k: getattr(fn, k) for k in self.shape_params}
        params["loc"] = loc * centered
        params["scale"] = scale ** centered
        decentered_fn = _wrap(type(fn)(**params), shape, event_dim)
        decentered = primitives.sample(f"{name}_decentered", decentered_fn,
                                       infer={"reparam_auxiliary": True})
        value = loc + scale ** (1 - centered) * (decentered - centered * loc)
        return None, value
