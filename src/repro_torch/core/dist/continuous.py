"""Continuous distributions.

``sample`` draws on the CPU from the caller's ``torch.Generator`` (never the
global one) and moves the draw to the parameters' device, so a seed gives
the same values on every device.  Samplers clamp away from support
boundaries by the smallest representable step (``_tiny``, ``_below_one``),
so ``log_prob(sample())`` is finite in float32 even at extreme parameters.
``log_prob`` is the bare closed form (no support masking): inference only
evaluates it inside the support via ``biject_to``.
"""
from __future__ import annotations

import math

import torch

from . import constraints
from .distribution import (Distribution, ExpandedDistribution, param_like,
                           shape_of)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _tiny(dtype):
    return torch.finfo(dtype).tiny


def _below_one(dtype):
    # the largest value below 1.0: 1 - 2^-(mantissa bits + 1), numpy's
    # finfo(dtype).epsneg (torch's eps is twice that)
    return 1.0 - torch.finfo(dtype).eps / 2


def _params(*values):
    """(dtype, device) of a draw for these parameters: the first floating
    tensor's, else the default dtype on the CPU."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.dtype, v.device
    return param_like(values[0])


def _host(value, dtype, shape):
    """A parameter as a contiguous CPU tensor of ``shape``: the operand of a
    CPU draw (``torch._standard_gamma`` takes its shape from it)."""
    return torch.as_tensor(value).detach().to("cpu", dtype) \
        .broadcast_to(shape).contiguous()


class Normal(Distribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale
        super().__init__(torch.broadcast_shapes(shape_of(loc), shape_of(scale)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.loc, self.scale)
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          dtype=dtype).to(device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - _HALF_LOG_2PI


class LogNormal(Distribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.positive

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale
        super().__init__(torch.broadcast_shapes(shape_of(loc), shape_of(scale)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.loc, self.scale)
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          dtype=dtype).to(device)
        return torch.exp(self.loc + self.scale * eps)

    def log_prob(self, value):
        log_value = torch.log(value)
        z = (log_value - self.loc) / self.scale
        return (-0.5 * z * z - _log(self.scale) - _HALF_LOG_2PI
                - log_value)


class Cauchy(Distribution):
    arg_constraints = {"loc": constraints.real, "scale": constraints.positive}
    support = constraints.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale
        super().__init__(torch.broadcast_shapes(shape_of(loc), shape_of(scale)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.loc, self.scale)
        eps = torch.empty(self.shape(sample_shape), dtype=dtype).cauchy_(
            generator=generator).to(device)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -math.log(math.pi) - _log(self.scale) - torch.log1p(z * z)


class StudentT(Distribution):
    arg_constraints = {"df": constraints.positive, "loc": constraints.real,
                       "scale": constraints.positive}
    support = constraints.real

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df = df
        self.loc = loc
        self.scale = scale
        super().__init__(torch.broadcast_shapes(
            shape_of(df), shape_of(loc), shape_of(scale)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.df, self.loc, self.scale)
        shape = self.shape(sample_shape)
        z = torch.randn(shape, generator=generator, dtype=dtype)
        half_df = _host(self.df, dtype, shape) / 2.0
        chi2 = 2.0 * torch._standard_gamma(half_df, generator=generator)
        # clamp the chi2 draw so extreme small-df tails stay finite in f32
        chi2 = chi2.clamp(min=_tiny(dtype))
        t = (z * torch.sqrt(2.0 * half_df / chi2)).to(device)
        return self.loc + self.scale * t

    def log_prob(self, value):
        df = torch.as_tensor(self.df)
        z = (value - self.loc) / self.scale
        return (torch.lgamma((df + 1.0) / 2.0) - torch.lgamma(df / 2.0)
                - 0.5 * torch.log(df * math.pi) - _log(self.scale)
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))


class Gamma(Distribution):
    arg_constraints = {"concentration": constraints.positive,
                       "rate": constraints.positive}
    support = constraints.positive

    def __init__(self, concentration, rate=1.0):
        self.concentration = concentration
        self.rate = rate
        super().__init__(torch.broadcast_shapes(
            shape_of(concentration), shape_of(rate)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.concentration, self.rate)
        conc = _host(self.concentration, dtype, self.shape(sample_shape))
        std = torch._standard_gamma(conc, generator=generator)
        return std.clamp(min=_tiny(dtype)).to(device) / self.rate

    def log_prob(self, value):
        conc = torch.as_tensor(self.concentration)
        return (conc * _log(self.rate) + (conc - 1.0) * torch.log(value)
                - self.rate * value - torch.lgamma(conc))


class InverseGamma(Distribution):
    """If X ~ Gamma(concentration, 1) then rate/X ~ InverseGamma, with
    density rate^c / Gamma(c) * x^{-c-1} exp(-rate/x) (scipy's ``invgamma``
    with ``a=concentration, scale=rate``)."""

    arg_constraints = {"concentration": constraints.positive,
                       "rate": constraints.positive}
    support = constraints.positive

    def __init__(self, concentration, rate=1.0):
        self.concentration = concentration
        self.rate = rate
        super().__init__(torch.broadcast_shapes(
            shape_of(concentration), shape_of(rate)))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.concentration, self.rate)
        conc = _host(self.concentration, dtype, self.shape(sample_shape))
        std = torch._standard_gamma(conc, generator=generator)
        return self.rate / std.clamp(min=_tiny(dtype)).to(device)

    def log_prob(self, value):
        conc = torch.as_tensor(self.concentration)
        return (conc * _log(self.rate) - (conc + 1.0) * torch.log(value)
                - self.rate / value - torch.lgamma(conc))


class Beta(Distribution):
    arg_constraints = {"concentration1": constraints.positive,
                       "concentration0": constraints.positive}
    support = constraints.unit_interval

    def __init__(self, concentration1, concentration0):
        self.concentration1 = concentration1
        self.concentration0 = concentration0
        super().__init__(torch.broadcast_shapes(
            shape_of(concentration1), shape_of(concentration0)))

    def sample(self, generator=None, sample_shape=()):
        """The first coordinate of a two-category Dirichlet draw
        (``torch._sample_dirichlet``, which stays finite at small
        concentrations where two normalized gammas would underflow)."""
        dtype, device = _params(self.concentration1, self.concentration0)
        shape = self.shape(sample_shape)
        conc = torch.stack([_host(self.concentration1, dtype, shape),
                            _host(self.concentration0, dtype, shape)], -1)
        x = torch._sample_dirichlet(conc, generator=generator)[..., 0]
        return x.clamp(_tiny(dtype), _below_one(dtype)).to(device)

    def log_prob(self, value):
        a = torch.as_tensor(self.concentration1)
        b = torch.as_tensor(self.concentration0)
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return ((a - 1.0) * torch.log(value) + (b - 1.0) * torch.log1p(-value)
                - betaln)


class Exponential(Distribution):
    arg_constraints = {"rate": constraints.positive}
    support = constraints.positive

    def __init__(self, rate=1.0):
        self.rate = rate
        super().__init__(shape_of(rate))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.rate)
        std = torch.empty(self.shape(sample_shape), dtype=dtype).exponential_(
            generator=generator)
        return std.clamp(min=_tiny(dtype)).to(device) / self.rate

    def log_prob(self, value):
        return _log(self.rate) - self.rate * value


class HalfNormal(Distribution):
    arg_constraints = {"scale": constraints.positive}
    support = constraints.positive

    def __init__(self, scale=1.0):
        self.scale = scale
        super().__init__(shape_of(scale))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.scale)
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          dtype=dtype).to(device)
        return torch.abs(self.scale * eps).clamp(min=_tiny(dtype))

    def log_prob(self, value):
        z = value / self.scale
        return (math.log(2.0) - 0.5 * z * z - _log(self.scale)
                - _HALF_LOG_2PI)


class HalfCauchy(Distribution):
    arg_constraints = {"scale": constraints.positive}
    support = constraints.positive

    def __init__(self, scale=1.0):
        self.scale = scale
        super().__init__(shape_of(scale))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = _params(self.scale)
        eps = torch.empty(self.shape(sample_shape), dtype=dtype).cauchy_(
            generator=generator).to(device)
        return torch.abs(self.scale * eps).clamp(min=_tiny(dtype))

    def log_prob(self, value):
        z = value / self.scale
        return (math.log(2.0 / math.pi) - _log(self.scale)
                - torch.log1p(z * z))


class Dirichlet(Distribution):
    arg_constraints = {"concentration": constraints.positive_vector}
    support = constraints.simplex

    def __init__(self, concentration):
        self.concentration = concentration
        shape = shape_of(concentration)
        if len(shape) < 1:
            raise ValueError("Dirichlet concentration must be at least 1-d")
        super().__init__(shape[:-1], shape[-1:])

    def sample(self, generator=None, sample_shape=()):
        """Normalized standard-gamma draws, made on the CPU from
        ``generator`` (never the global generator) and moved to the
        concentration's device."""
        conc = torch.as_tensor(self.concentration)
        dtype, device = param_like(conc)
        shape = self.shape(sample_shape)
        gammas = torch._standard_gamma(
            conc.detach().to("cpu", dtype).broadcast_to(shape).contiguous(),
            generator=generator)
        x = gammas.clamp(min=torch.finfo(dtype).tiny)
        return (x / x.sum(-1, keepdim=True)).to(device)

    def log_prob(self, value):
        conc = torch.as_tensor(self.concentration)
        normalizer = torch.lgamma(conc.sum(-1)) - torch.lgamma(conc).sum(-1)
        return torch.sum((conc - 1.0) * torch.log(value), dim=-1) + normalizer


def _nan_where_failed(factor, info):
    """``factor`` with every matrix whose factorization failed (``info !=
    0``) set to NaN: the JAX package's ``jnp.linalg.cholesky`` semantics,
    which its NUTS reads as a divergence, without the host read (a sync per
    gradient on a card) that ``torch.linalg.cholesky`` makes to raise."""
    ok = (info == 0)[..., None, None]
    return torch.where(ok, factor, torch.full_like(factor, math.nan))


class MultivariateNormal(Distribution):
    """Parametrized by exactly one of ``covariance_matrix``,
    ``precision_matrix`` or ``scale_tril``; the first two are factored with
    ``torch.linalg.cholesky_ex`` (a matrix that is not positive definite
    gives a NaN factor, and so a NaN density, rather than an error)."""

    arg_constraints = {"loc": constraints.real_vector,
                       "scale_tril": constraints.lower_cholesky}
    support = constraints.real_vector

    def __init__(self, loc=0.0, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None):
        if sum(p is not None for p in
               (covariance_matrix, precision_matrix, scale_tril)) != 1:
            raise ValueError("provide exactly one of covariance_matrix, "
                             "precision_matrix, scale_tril")
        if covariance_matrix is not None:
            scale_tril = _nan_where_failed(
                *torch.linalg.cholesky_ex(covariance_matrix))
        elif precision_matrix is not None:
            inv, inv_info = torch.linalg.inv_ex(precision_matrix)
            factor, info = torch.linalg.cholesky_ex(inv)
            scale_tril = _nan_where_failed(factor, info | inv_info)
        scale_tril = torch.as_tensor(scale_tril)
        dim = scale_tril.shape[-1]
        if len(shape_of(loc)) == 0:
            loc = torch.as_tensor(loc, dtype=scale_tril.dtype,
                                  device=scale_tril.device).broadcast_to((dim,))
        self.loc = loc
        self.scale_tril = scale_tril
        batch_shape = torch.broadcast_shapes(shape_of(loc)[:-1],
                                             shape_of(scale_tril)[:-2])
        super().__init__(batch_shape, (dim,))

    def sample(self, generator=None, sample_shape=()):
        dtype, device = param_like(self.scale_tril)
        eps = torch.randn(self.shape(sample_shape), generator=generator,
                          dtype=dtype).to(device)
        return self.loc + (self.scale_tril @ eps[..., None])[..., 0]

    def log_prob(self, value):
        diff = value - self.loc
        tril = self.scale_tril
        batch = torch.broadcast_shapes(diff.shape[:-1], tril.shape[:-2])
        tril = tril.broadcast_to(batch + tril.shape[-2:])
        diff = diff.broadcast_to(batch + diff.shape[-1:])
        m = torch.linalg.solve_triangular(tril, diff[..., None],
                                          upper=False)[..., 0]
        half_log_det = torch.sum(
            torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)), dim=-1)
        dim = self.event_shape[0]
        return (-0.5 * torch.sum(m * m, dim=-1) - half_log_det
                - dim * _HALF_LOG_2PI)


class Delta(Distribution):
    """Point mass at ``v``, optionally carrying an extra ``log_density`` term
    (used to book-keep marginalized factors in models)."""

    arg_constraints = {"v": constraints.real, "log_density": constraints.real}
    support = constraints.real

    def __init__(self, v=0.0, log_density=0.0, event_dim=0):
        if event_dim > len(shape_of(v)):
            raise ValueError("event_dim exceeds ndim of the Delta value")
        self.v = v
        self.log_density = log_density
        shape = shape_of(v)
        split = len(shape) - event_dim
        super().__init__(shape[:split], shape[split:])

    def sample(self, generator=None, sample_shape=()):
        return torch.as_tensor(self.v).broadcast_to(self.shape(sample_shape))

    def log_prob(self, value):
        value = torch.as_tensor(value)
        dtype = value.dtype if value.is_floating_point() \
            else torch.get_default_dtype()
        log_prob = torch.where(value == self.v, 0.0, -math.inf).to(dtype)
        log_prob = log_prob + self.log_density
        dims = tuple(range(-len(self.event_shape), 0))
        return torch.sum(log_prob, dim=dims) if dims else log_prob

    def expand(self, batch_shape):
        return ExpandedDistribution(self, tuple(batch_shape))
