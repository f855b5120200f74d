"""The port's distribution library against the JAX package's, on the same
numpy inputs:

- every ``log_prob`` against the reference's and against scipy's closed
  forms (the table of ``tests/test_dist_golden.py``), in float64 (the
  reference under ``jax.enable_x64``; 1e-12 relative) and in float32 (2e-5,
  the golden test's bound);
- every transform's ``inv`` and round trip, and ``log_abs_det_jacobian``
  against ``torch.autograd.functional.jacobian`` (float64, 1e-10) and the
  reference (float32, 1e-5);
- ``biject_to`` of every constraint the reference registers, and the
  discrete ones raising;
- ``MultivariateNormal``'s three parametrisations and a batched case
  against the reference, and a covariance that is not positive definite
  giving NaN rather than raising;
- sample moments and quantiles within Monte Carlo error of scipy's, and
  ``log_prob(sample())`` finite at the reference's extreme parameters;
- ``DiscreteUniform``, ``TransformedDistribution`` and the package's
  exported names.
"""
import numpy as np
import pytest
import scipy.stats as sps
import torch

import jax
import jax.numpy as jnp

import repro.core.dist as jdist
from repro.core.dist import constraints as jconstraints
from repro.core.dist import transforms as jtransforms
from repro_torch.core import dist
from repro_torch.core.dist import constraints, transforms

POSITIVE_X = np.array([0.05, 0.4, 1.0, 2.5, 7.0])
REAL_X = np.array([-2.5, -0.3, 0.0, 0.7, 3.1])
UNIT_X = np.array([0.05, 0.3, 0.5, 0.8, 0.97])

# name -> (params, scipy frozen distribution, points): the golden table
GOLDEN = {
    "Normal": ((0.5, 1.3), sps.norm(0.5, 1.3), REAL_X),
    "LogNormal": ((0.2, 0.8), sps.lognorm(s=0.8, scale=np.exp(0.2)),
                  POSITIVE_X),
    "Cauchy": ((-0.3, 2.0), sps.cauchy(-0.3, 2.0), REAL_X),
    "StudentT": ((3.5, 0.5, 2.0), sps.t(3.5, loc=0.5, scale=2.0), REAL_X),
    "Gamma": ((2.5, 3.0), sps.gamma(2.5, scale=1 / 3.0), POSITIVE_X),
    "Beta": ((2.0, 5.0), sps.beta(2.0, 5.0), UNIT_X),
    "Exponential": ((1.7,), sps.expon(scale=1 / 1.7), POSITIVE_X),
    "HalfNormal": ((2.0,), sps.halfnorm(scale=2.0), POSITIVE_X),
    "HalfCauchy": ((2.0,), sps.halfcauchy(scale=2.0), POSITIVE_X),
    "InverseGamma": ((3.0, 2.0), sps.invgamma(3.0, scale=2.0), POSITIVE_X),
}
DTYPES = {"float64": (torch.float64, jnp.float64, 1e-12, 1e-12),
          "float32": (torch.float32, jnp.float32, 2e-5, 2e-5)}


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _j(x, dtype):
    return jnp.asarray(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(GOLDEN))
def test_log_prob_matches_reference_and_scipy(name, dtype):
    tdt, jdt, rtol, atol = DTYPES[dtype]
    params, ref, xs = GOLDEN[name]
    ours = getattr(dist, name)(*(_t(p, tdt) for p in params)).log_prob(
        _t(xs, tdt))
    assert ours.dtype == tdt
    with jax.enable_x64(dtype == "float64"):
        theirs = np.asarray(getattr(jdist, name)(
            *(_j(p, jdt) for p in params)).log_prob(_j(xs, jdt)))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=rtol, atol=atol)
    np.testing.assert_allclose(ours.numpy(), ref.logpdf(xs), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", list(GOLDEN))
def test_log_prob_broadcasts_and_differentiates(name):
    """Batched parameters broadcast with the value, as the reference's do,
    and the gradient is finite inside the support."""
    params, _, xs = GOLDEN[name]
    batched = [torch.full((len(xs),), float(p), dtype=torch.float64,
                          requires_grad=True) for p in params]
    d = getattr(dist, name)(*batched)
    assert d.batch_shape == (len(xs),)
    lp = d.log_prob(_t(xs, torch.float64))
    np.testing.assert_allclose(lp.detach().numpy(),
                               GOLDEN[name][1].logpdf(xs), rtol=1e-12)
    grads = torch.autograd.grad(lp.sum(), batched)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _transforms():
    rng = np.random.default_rng(0)
    loc, scale = rng.standard_normal(4), rng.uniform(0.5, 2.0, 4) * [1, -1, 1, 1]
    return {
        "Affine": (lambda m: m.AffineTransform(loc, scale), (4,)),
        "Exp": (lambda m: m.ExpTransform(), (4,)),
        "Sigmoid": (lambda m: m.SigmoidTransform(), (4,)),
        "Interval": (lambda m: m.IntervalTransform(-2.0, 3.0), (4,)),
        "StickBreaking": (lambda m: m.StickBreakingTransform(), (4,)),
        "LowerCholesky": (lambda m: m.LowerCholeskyTransform(), (6,)),
    }


TRANSFORMS = _transforms()


def _ours(name, dtype=torch.float64):
    t = TRANSFORMS[name][0](transforms)
    if name == "Affine":
        t = transforms.AffineTransform(_t(t.loc, dtype), _t(t.scale, dtype))
    return t


def _dense_jacobian_logdet(name, t, x):
    """log |det dy/dx| of the square map from ``x`` to the free
    coordinates of ``y``."""
    def free(u):
        y = t(u)
        if name == "StickBreaking":
            return y[:-1]
        if name == "LowerCholesky":
            d = y.shape[-1]
            rows, cols = torch.tril_indices(d, d, -1)
            return torch.cat([y[rows, cols], torch.diagonal(y)])
        return y

    jac = torch.autograd.functional.jacobian(free, x)
    return torch.linalg.slogdet(jac)[1]


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_round_trip_and_jacobian(name):
    shape = TRANSFORMS[name][1]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    t = _ours(name)
    y = t(x)
    assert bool(t.codomain(y).all()) if t.codomain.event_dim == 0 \
        else bool(t.codomain(y))
    np.testing.assert_allclose(t.inv(y).numpy(), x.numpy(), atol=1e-10)
    ladj = t.log_abs_det_jacobian(x, y).sum()
    np.testing.assert_allclose(float(ladj),
                               float(_dense_jacobian_logdet(name, t, x)),
                               rtol=1e-10, atol=1e-10)
    assert tuple(y.shape) == t.forward_shape(tuple(x.shape))


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_reference(name):
    shape = TRANSFORMS[name][1]
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    t, jt = _ours(name, torch.float32), TRANSFORMS[name][0](jtransforms)
    y, jy = t(torch.from_numpy(x)), jt(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t.inv(y).numpy(), np.asarray(jt.inv(jy)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t.log_abs_det_jacobian(torch.from_numpy(x), y).numpy(),
        np.asarray(jt.log_abs_det_jacobian(jnp.asarray(x), jy)),
        rtol=1e-5, atol=1e-5)


# every constraint the reference registers, with an unconstrained point
CONSTRAINTS = {
    "real": (constraints.real, jconstraints.real, (3,)),
    "real_vector": (constraints.real_vector, jconstraints.real_vector, (3,)),
    "positive": (constraints.positive, jconstraints.positive, (3,)),
    "positive_vector": (constraints.positive_vector,
                        jconstraints.positive_vector, (3,)),
    "unit_interval": (constraints.unit_interval, jconstraints.unit_interval,
                      (3,)),
    "interval": (constraints.interval(1.0, 4.0),
                 jconstraints.interval(1.0, 4.0), (3,)),
    "simplex": (constraints.simplex, jconstraints.simplex, (3,)),
    "lower_cholesky": (constraints.lower_cholesky,
                       jconstraints.lower_cholesky, (6,)),
}


@pytest.mark.parametrize("name", list(CONSTRAINTS))
def test_biject_to_every_registered_constraint(name):
    c, jc, shape = CONSTRAINTS[name]
    u = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    t, jt = dist.biject_to(c), jdist.biject_to(jc)
    assert type(t).__name__ == type(jt).__name__
    y = t(torch.from_numpy(u))
    np.testing.assert_allclose(y.numpy(), np.asarray(jt(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-6)
    assert bool(torch.all(c(y)))
    np.testing.assert_allclose(t.inv(y).numpy(), u, atol=2e-5)


def test_unit_interval_is_an_interval_and_discrete_supports_raise():
    assert isinstance(constraints.unit_interval, constraints._Interval)
    assert repr(constraints.unit_interval) == repr(jconstraints.unit_interval)
    for c in (constraints.boolean, constraints.integer_interval(0, 3)):
        with pytest.raises(NotImplementedError, match="discrete supports"):
            dist.biject_to(c)
    tril = torch.tensor([[1.0, 0.0], [0.5, 2.0]])
    assert bool(constraints.lower_cholesky(tril))
    assert not bool(constraints.lower_cholesky(tril.T))
    assert not bool(constraints.lower_cholesky(-tril))


# ---------------------------------------------------------------------------
# MultivariateNormal
# ---------------------------------------------------------------------------

def _spd(rng, d, batch=()):
    a = rng.standard_normal(batch + (d, d))
    return a @ np.swapaxes(a, -1, -2) + d * np.eye(d)


@pytest.mark.parametrize("param", ["covariance_matrix", "precision_matrix",
                                   "scale_tril"])
def test_mvn_parametrisations_match_reference(param):
    rng = np.random.default_rng(4)
    cov = _spd(rng, 5)
    mat = {"covariance_matrix": cov, "precision_matrix": np.linalg.inv(cov),
           "scale_tril": np.linalg.cholesky(cov)}[param]
    loc = rng.standard_normal(5)
    x = rng.standard_normal((3, 5))
    want = sps.multivariate_normal(loc, cov).logpdf(x)
    ours = dist.MultivariateNormal(torch.from_numpy(loc),
                                   **{param: torch.from_numpy(mat)})
    np.testing.assert_allclose(ours.log_prob(torch.from_numpy(x)).numpy(),
                               want, rtol=1e-10)
    np.testing.assert_allclose(ours.scale_tril.numpy(),
                               np.linalg.cholesky(cov), rtol=1e-8,
                               atol=1e-10)
    f32 = dist.MultivariateNormal(torch.from_numpy(loc).float(),
                                  **{param: torch.from_numpy(mat).float()})
    theirs = jdist.MultivariateNormal(jnp.asarray(loc, jnp.float32),
                                      **{param: jnp.asarray(mat,
                                                            jnp.float32)})
    np.testing.assert_allclose(
        f32.log_prob(torch.from_numpy(x).float()).numpy(),
        np.asarray(theirs.log_prob(jnp.asarray(x, jnp.float32))),
        rtol=2e-5, atol=2e-5)


def test_mvn_batches_like_reference():
    """Batched covariances against a batch of values and a shared value,
    and a scalar loc broadcast to the event (reference
    ``continuous.py:305-318``)."""
    rng = np.random.default_rng(5)
    cov = _spd(rng, 3, (4,))
    loc = rng.standard_normal((2, 1, 3))
    x = rng.standard_normal((4, 3))
    ours = dist.MultivariateNormal(torch.from_numpy(loc),
                                   covariance_matrix=torch.from_numpy(cov))
    assert ours.batch_shape == (2, 4) and ours.event_shape == (3,)
    with jax.enable_x64(True):
        theirs = jdist.MultivariateNormal(jnp.asarray(loc),
                                          covariance_matrix=jnp.asarray(cov))
        for value in (x, x[0]):
            np.testing.assert_allclose(
                ours.log_prob(torch.from_numpy(value)).numpy(),
                np.asarray(theirs.log_prob(jnp.asarray(value))),
                rtol=1e-12)
        scalar = dist.MultivariateNormal(0.0, covariance_matrix=torch.eye(3,
                                         dtype=torch.float64))
        np.testing.assert_allclose(
            scalar.log_prob(torch.from_numpy(x)).numpy(),
            np.asarray(jdist.MultivariateNormal(
                0.0, covariance_matrix=jnp.eye(3)).log_prob(
                    jnp.asarray(x))), rtol=1e-12)
    expanded = ours.expand((5, 2, 4))
    assert expanded.log_prob(torch.from_numpy(x)).shape == (5, 2, 4)


def test_mvn_not_positive_definite_gives_nan_without_raising():
    """``jnp.linalg.cholesky`` returns NaN for a matrix that is not positive
    definite (the reference's NUTS reads it as a divergence); so does the
    port, through ``cholesky_ex``, and only the failed matrix of a batch."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    good = np.eye(2)
    cov = torch.from_numpy(np.stack([good, bad]))
    d = dist.MultivariateNormal(torch.zeros(2, dtype=torch.float64),
                                covariance_matrix=cov)
    lp = d.log_prob(torch.ones(2, dtype=torch.float64))
    assert bool(torch.isfinite(lp[0])) and bool(torch.isnan(lp[1]))
    theirs = jdist.MultivariateNormal(jnp.zeros(2),
                                      covariance_matrix=jnp.asarray(bad))
    assert bool(jnp.isnan(theirs.log_prob(jnp.ones(2))))
    prec = dist.MultivariateNormal(0.0, precision_matrix=torch.from_numpy(bad))
    assert bool(torch.isnan(prec.log_prob(torch.ones(2,
                                                     dtype=torch.float64))))


def test_mvn_sample_moments():
    rng = np.random.default_rng(6)
    cov, loc = _spd(rng, 3), rng.standard_normal(3)
    d = dist.MultivariateNormal(torch.from_numpy(loc),
                                covariance_matrix=torch.from_numpy(cov))
    n = 20000
    x = d.sample(torch.Generator().manual_seed(0), (n,)).numpy()
    assert x.shape == (n, 3)
    se = np.sqrt(np.diag(cov) / n)
    assert np.all(np.abs(x.mean(0) - loc) < 4 * se)
    emp = np.cov(x.T)
    se_cov = np.sqrt((cov ** 2 + np.outer(np.diag(cov), np.diag(cov))) / n)
    assert np.all(np.abs(emp - cov) < 4 * se_cov)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

# scipy's (mean, variance) exist where the fourth moment does too, so the
# variance's Monte Carlo error is finite
FINITE_MOMENTS = ("Normal", "LogNormal", "Gamma", "Beta", "Exponential",
                  "HalfNormal")


@pytest.mark.parametrize("name", list(GOLDEN))
def test_samples_agree_with_scipy_within_mc_error(name):
    """The empirical cdf at scipy's quartiles within 4 binomial standard
    errors, and (where the fourth moment is finite) mean and variance
    within 4 Monte Carlo standard errors."""
    params, ref, _ = GOLDEN[name]
    n = 20000
    d = getattr(dist, name)(*(_t(p, torch.float64) for p in params))
    x = d.sample(torch.Generator().manual_seed(11), (n,)).numpy()
    assert x.shape == (n,) and x.dtype == np.float64
    for q in (0.25, 0.5, 0.75):
        emp = np.mean(x <= ref.ppf(q))
        assert abs(emp - q) < 4 * np.sqrt(q * (1 - q) / n), (q, emp)
    if name in FINITE_MOMENTS:
        mean, var = ref.mean(), ref.var()
        assert abs(x.mean() - mean) < 4 * np.sqrt(var / n)
        mu4 = ref.moment(4) - 4 * mean * ref.moment(3) \
            + 6 * mean ** 2 * ref.moment(2) - 3 * mean ** 4
        assert abs(x.var() - var) < 4 * np.sqrt((mu4 - var ** 2) / n)


def test_samples_draw_from_the_given_generator_only():
    torch.manual_seed(0)
    a = dist.Gamma(2.0, 1.0).sample(torch.Generator().manual_seed(3), (5,))
    torch.manual_seed(1)
    b = dist.Gamma(2.0, 1.0).sample(torch.Generator().manual_seed(3), (5,))
    assert torch.equal(a, b)


# the reference's extreme parameters: the corners of test_distributions.py's
# strategies (positive in [0.125, 4], finite in [-4, 4])
EXTREMES = {
    "Normal": [(-4.0, 0.125), (4.0, 4.0)],
    "LogNormal": [(-4.0, 4.0), (4.0, 0.125)],
    "Cauchy": [(-4.0, 0.125), (4.0, 4.0)],
    "StudentT": [(0.125, -4.0, 4.0), (4.0, 4.0, 0.125)],
    "Gamma": [(0.125, 4.0), (0.125, 0.125), (4.0, 0.125)],
    "Beta": [(0.125, 0.125), (0.125, 4.0), (4.0, 0.125)],
    "Exponential": [(0.125,), (4.0,)],
    "HalfNormal": [(0.125,), (4.0,)],
    "HalfCauchy": [(0.125,), (4.0,)],
    "InverseGamma": [(0.125, 4.0), (0.125, 0.125), (4.0, 0.125)],
}


@pytest.mark.parametrize("name", list(EXTREMES))
def test_log_prob_of_sample_finite_at_extreme_parameters(name):
    gen = torch.Generator().manual_seed(12)
    for params in EXTREMES[name]:
        d = getattr(dist, name)(*(_t(p, torch.float32) for p in params))
        x = d.sample(gen, (2000,))
        assert x.dtype == torch.float32
        assert bool(torch.isfinite(d.log_prob(x)).all()), (name, params)
        assert bool(d.support(x).all()), (name, params)


# ---------------------------------------------------------------------------
# DiscreteUniform, TransformedDistribution, exports
# ---------------------------------------------------------------------------

def test_discrete_uniform_matches_reference():
    d, jd = dist.DiscreteUniform(2, 6), jdist.DiscreteUniform(2, 6)
    xs = np.array([1, 2, 4, 6, 7])
    np.testing.assert_allclose(d.log_prob(torch.from_numpy(xs)).numpy(),
                               np.asarray(jd.log_prob(jnp.asarray(xs))),
                               rtol=1e-6)
    np.testing.assert_array_equal(d.enumerate_support().numpy(),
                                  np.asarray(jd.enumerate_support()))
    assert d.enumerate_support(expand=False).shape == (5,)
    draws = d.sample(torch.Generator().manual_seed(0), (500,))
    assert draws.dtype == torch.int32
    assert set(draws.tolist()) == {2, 3, 4, 5, 6}
    expanded = d.expand((3,))
    assert expanded.enumerate_support().shape == (5, 3)
    assert expanded.sample(torch.Generator()).shape == (3,)
    with pytest.raises(ValueError, match="low <= high"):
        dist.DiscreteUniform(3, 2)


def test_transformed_distribution_matches_reference():
    rng = np.random.default_rng(7)
    loc, scale = rng.standard_normal(8), rng.uniform(0.5, 2.0, 8)
    ours = dist.TransformedDistribution(
        dist.Normal(0.0, 1.0), [dist.AffineTransform(
            torch.from_numpy(loc), torch.from_numpy(scale)),
            transforms.ExpTransform()])
    assert ours.batch_shape == (8,) and ours.event_shape == ()
    assert ours.support is constraints.positive
    with jax.enable_x64(True):
        theirs = jdist.TransformedDistribution(
            jdist.Normal(0.0, 1.0), [jdist.AffineTransform(
                jnp.asarray(loc), jnp.asarray(scale)),
                jtransforms.ExpTransform()])
        for value in (np.float64(1.3), rng.uniform(0.5, 2.0, 8)):
            np.testing.assert_allclose(
                ours.log_prob(torch.as_tensor(value)).numpy(),
                np.asarray(theirs.log_prob(jnp.asarray(value))), rtol=1e-12)
    np.testing.assert_allclose(
        ours.log_prob(torch.tensor(1.3, dtype=torch.float64)).numpy(),
        sps.lognorm(s=scale, scale=np.exp(loc)).logpdf(1.3), rtol=1e-12)
    x = ours.sample(torch.Generator().manual_seed(0), (4000,))
    assert x.shape == (4000, 8) and bool((x > 0).all())
    # independent base draws along the broadcast dim, not a shared epsilon
    z = (torch.log(x) - torch.from_numpy(loc)) / torch.from_numpy(scale)
    assert float(torch.corrcoef(z[:, :2].T)[0, 1].abs()) < 0.1
    # an event-shaped base keeps its event dims
    ev = dist.TransformedDistribution(
        dist.Normal(torch.zeros(3, dtype=torch.float64), 1.0).to_event(1),
        dist.AffineTransform(1.0, 2.0))
    assert ev.batch_shape == () and ev.event_shape == (3,)
    np.testing.assert_allclose(
        float(ev.log_prob(torch.ones(3, dtype=torch.float64))),
        3 * sps.norm(1.0, 2.0).logpdf(1.0), rtol=1e-12)


def test_transformed_distribution_support_rules():
    """The reference's rules: a constrained base, or a constraining
    transform before the last one, has no representable support."""
    with pytest.raises(NotImplementedError, match="base support"):
        dist.TransformedDistribution(dist.Gamma(2.0, 1.0),
                                     dist.AffineTransform(0.0, 2.0)).support
    with pytest.raises(NotImplementedError, match="non-final transform"):
        dist.TransformedDistribution(
            dist.Normal(0.0, 1.0), [transforms.ExpTransform(),
                                    dist.AffineTransform(0.0, 2.0)]).support
    with pytest.raises(ValueError, match="event shape"):
        dist.TransformedDistribution(
            dist.Normal(torch.zeros(2), 1.0).to_event(1),
            transforms.StickBreakingTransform())
    with pytest.raises(ValueError, match=">= 1 transform"):
        dist.TransformedDistribution(dist.Normal(0.0, 1.0), [])


def test_exports_match_reference():
    assert set(jdist.__all__) <= set(dist.__all__)
    for name in jdist.__all__:
        assert hasattr(dist, name), name
    assert set(jconstraints.__all__) == set(constraints.__all__)
    assert set(jtransforms.__all__) == set(transforms.__all__)
