"""The rest of the port's handler core against the JAX package's, on the
same numpy inputs: ``replay``, ``mask``, ``scale``, ``do``, ``reparam``
(``LocScaleReparam``, ``TransformReparam``), the ``subsample`` primitive,
``Predictive``, ``log_likelihood``, ``constrain_fn``, ``initialize_model``
and ``init_strategy="prior"``.

Random draws cannot agree across the two packages (JAX threefry against
torch's generators), so every comparison pins the values: latents through
``substitute``/``condition``/``replay``, minibatch indices through the plate
site.  Each check compares the traces site by site (names, types, values,
``scale``, ``mask``, observedness) and the joint log density, within 1e-6
(float32).  The semantics are those of ``tests/test_handlers.py``,
``tests/test_handler_matrix.py``, ``tests/test_reparam.py`` and
``tests/test_predictive.py``.  Eight schools runs at level 3: NUTS on the
non-centered model agrees with the reference's posterior within 4 Monte
Carlo standard errors, with split R-hat under the example's 1.05.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jpc
from repro.core import dist as jdist
from repro.core import handlers as jh
from repro.core import reparam as jreparam
from repro.core.infer import MCMC as JMCMC
from repro.core.infer import NUTS as JNUTS
from repro.core.infer import Predictive as JPredictive
from repro.core.infer import constrain_fn as j_constrain_fn
from repro.core.infer import initialize_model as j_initialize_model
from repro.core.infer import log_density as j_log_density
from repro.core.infer import log_likelihood as j_log_likelihood
from repro_torch import core as pc
from repro_torch.bench.models import eight_schools, eight_schools_data
from repro_torch.core import dist
from repro_torch.core import handlers as h
from repro_torch.core.errors import ReproError
from repro_torch.core.infer import (MCMC, NUTS, Predictive, constrain_fn,
                                    effective_sample_size, gelman_rubin,
                                    initialize_model, log_density,
                                    log_likelihood)
from repro_torch.core.reparam import LocScaleReparam, TransformReparam

TOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _view(tr):
    """A trace as comparable numpy: name -> (type, observed, value, scale,
    mask)."""
    out = {}
    for name, site in tr.items():
        scale = site.get("scale")
        mask = site.get("mask")
        out[name] = (site["type"], bool(site["is_observed"]),
                     _np(site["value"]).astype(np.float64),
                     None if scale is None else float(np.asarray(
                         _np(scale)).reshape(-1)[0]),
                     None if mask is None else _np(mask).astype(bool))
    return out


def assert_same_trace(tr, jtr):
    ours, theirs = _view(tr), _view(jtr)
    assert list(ours) == list(theirs)
    for name in ours:
        (t, o, v, s, m), (jt, jo, jv, js, jm) = ours[name], theirs[name]
        assert (t, o) == (jt, jo), name
        np.testing.assert_allclose(v, jv, rtol=TOL, atol=TOL, err_msg=name)
        assert (s is None) == (js is None), name
        if s is not None:
            assert abs(s - js) <= TOL * abs(js), name
        assert (m is None) == (jm is None), name
        if m is not None:
            np.testing.assert_array_equal(np.broadcast_to(m, jm.shape), jm)


def _pair(fn):
    """``fn(pc, dist, array)`` as a model of each package."""
    return (lambda *a, **k: fn(pc, dist, torch.as_tensor, *a, **k),
            lambda *a, **k: fn(jpc, jdist, jnp.asarray, *a, **k))


# ---------------------------------------------------------------------------
# mask / scale
# ---------------------------------------------------------------------------

KEEP = np.array([True, True, False, False])


def _obs_site(P, D, A):
    P.sample("z", D.Normal(0.0, 1.0).expand((4,)), obs=A(np.zeros(4,
                                                                  np.float32)))


@pytest.mark.parametrize("order", ["mask_outside", "scale_outside"])
def test_mask_wins_over_scale_in_either_order(order):
    def model(P, D, A):
        H = h if P is pc else jh
        outer, inner = (H.mask(mask=A(KEEP)), H.scale(scale=3.0))
        if order == "scale_outside":
            outer, inner = inner, outer
        with outer:
            with inner:
                _obs_site(P, D, A)

    ours, theirs = _pair(model)
    lp, tr = log_density(ours, (), {}, {})
    jlp, jtr = j_log_density(theirs, (), {}, {})
    assert_same_trace(tr, jtr)
    base = float(dist.Normal(0.0, 1.0).log_prob(torch.tensor(0.0)))
    assert abs(float(lp) - 3.0 * 2 * base) < 1e-5
    assert abs(float(lp) - float(jlp)) < 1e-5


def test_nested_scales_subsampled_plate_and_condition_multiply():
    idx = np.array([1, 3, 5, 7, 9])

    def model(P, D, A):
        H = h if P is pc else jh
        with H.scale(scale=2.0):
            with H.mask(mask=A(np.array([True, False, True, True, True]))):
                with P.plate("N", 10, subsample_size=5):
                    P.sample("z", D.Normal(0.0, 1.0))

    ours, theirs = _pair(model)
    lp, tr = log_density(h.condition(ours, {"z": torch.zeros(5)}), (), {},
                         {"N": torch.from_numpy(idx)})
    jlp, jtr = j_log_density(jh.condition(theirs, {"z": jnp.zeros(5)}), (),
                             {}, {"N": jnp.asarray(idx)})
    assert_same_trace(tr, jtr)
    assert tr["z"]["is_observed"] and tr["z"]["scale"] == 4.0
    assert abs(float(lp) - float(jlp)) < 1e-5


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

X = np.arange(10.0, dtype=np.float32)
Y = 2.0 * X


def _sub_model(P, D, A, x, y=None):
    w = P.sample("w", D.Normal(0.0, 1.0))
    with P.plate("N", 10, subsample_size=4) as idx:
        xb = P.subsample(x, event_dim=0)
        yb = P.subsample(y, event_dim=0) if y is not None else None
        P.sample("obs", D.Normal(w * xb, 1.0), obs=yb)
    return idx


def _guide(values, plate_idx):
    tr = {n: {"type": "sample", "value": v, "is_observed": False}
          for n, v in values.items()}
    tr["N"] = {"type": "plate", "value": plate_idx}
    return tr


def test_replay_pins_latents_and_minibatch_like_reference():
    ours, theirs = _pair(_sub_model)
    idx = np.array([8, 2, 5, 0])
    rtr = h.trace(h.replay(h.seed(ours, 99), _guide(
        {"w": torch.tensor(0.7)}, torch.from_numpy(idx)))).get_trace(
            torch.from_numpy(X), torch.from_numpy(Y))
    jtr = jh.trace(jh.replay(jh.seed(theirs, jax.random.PRNGKey(5)), _guide(
        {"w": jnp.asarray(0.7)}, jnp.asarray(idx)))).get_trace(
            jnp.asarray(X), jnp.asarray(Y))
    assert_same_trace(rtr, jtr)
    np.testing.assert_array_equal(rtr["obs"]["value"].numpy(), Y[idx])
    # a recording of the port replays the port exactly
    rec = h.trace(h.seed(ours, 3)).get_trace(torch.from_numpy(X),
                                             torch.from_numpy(Y))
    again = h.trace(h.replay(h.seed(ours, 4), rec)).get_trace(
        torch.from_numpy(X), torch.from_numpy(Y))
    assert torch.equal(again["N"]["value"], rec["N"]["value"])
    assert torch.equal(again["w"]["value"], rec["w"]["value"])


def test_replay_errors_like_reference():
    def model(P, D, A):
        P.sample("w", D.Normal(0.0, 1.0))

    ours, theirs = _pair(model)
    for handlers, m, val in ((h, ours, torch.tensor(1.0)),
                             (jh, theirs, jnp.asarray(1.0))):
        observed = {"w": {"type": "sample", "value": val,
                          "is_observed": True}}
        wrong = {"w": {"type": "param", "value": val, "is_observed": False}}
        for guide in (observed, wrong):
            with pytest.raises(RuntimeError, match="RPL011"):
                handlers.trace(handlers.replay(m, guide)).get_trace()
    with pytest.raises(ValueError, match="guide_trace"):
        h.replay(ours)
    # observed here: the data wins over the recording
    def obs_model(P, D, A):
        P.sample("w", D.Normal(0.0, 1.0), obs=A(np.float32(2.0)))

    tr = h.trace(h.replay(_pair(obs_model)[0], _guide(
        {"w": torch.tensor(1.0)}, torch.arange(4)))).get_trace()
    assert float(tr["w"]["value"]) == 2.0


# ---------------------------------------------------------------------------
# do
# ---------------------------------------------------------------------------

def _causal(P, D, A):
    a = P.sample("a", D.Normal(0.0, 1.0))
    b = P.sample("b", D.Normal(a, 1.0))
    return P.sample("c", D.Normal(b, 0.5))


def test_do_severs_like_reference():
    ours, theirs = _pair(_causal)
    tr = h.trace(h.substitute(h.do(ours, {"b": torch.tensor(3.0)}),
                              {"a": torch.tensor(0.5),
                               "c": torch.tensor(2.5)})).get_trace()
    jtr = jh.trace(jh.substitute(jh.do(theirs, {"b": jnp.asarray(3.0)}),
                                 {"a": jnp.asarray(0.5),
                                  "c": jnp.asarray(2.5)})).get_trace()
    assert_same_trace(tr, jtr)
    assert "b" not in tr  # stopped: outer handlers never see it
    lp, _ = log_density(h.do(ours, {"b": torch.tensor(3.0)}), (), {},
                        {"a": torch.tensor(0.5), "c": torch.tensor(2.5)})
    jlp, _ = j_log_density(jh.do(theirs, {"b": jnp.asarray(3.0)}), (), {},
                           {"a": jnp.asarray(0.5), "c": jnp.asarray(2.5)})
    assert abs(float(lp) - float(jlp)) < 1e-5
    # downstream uses the clamped value
    want = float(dist.Normal(3.0, 0.5).log_prob(torch.tensor(2.5))) \
        + float(dist.Normal(0.0, 1.0).log_prob(torch.tensor(0.5)))
    assert abs(float(lp) - want) < 1e-5


def test_do_errors_like_reference():
    ours, _ = _pair(_causal)
    with pytest.raises(ReproError, match="RPL006"):
        h.trace(h.seed(h.do(ours, {"bb": torch.tensor(1.0)}, strict=True),
                       0)).get_trace()
    rep = h.reparam(ours, config={"b": LocScaleReparam(0.0)})
    for handler in (h.do, h.condition):
        with pytest.raises(ReproError, match="RPL007"):
            h.trace(h.seed(handler(rep, data={"b": torch.tensor(1.0)}),
                           0)).get_trace()
    with pytest.raises(ReproError, match="RPL007"):
        h.trace(h.seed(h.substitute(rep, data={"b": torch.tensor(1.0)}),
                       0)).get_trace()
    from repro_torch.core.infer import enum

    def discrete():
        pc.sample("z", dist.Bernoulli(probs=torch.tensor(0.3)),
                  infer={"enumerate": "parallel"})

    for handler in (h.do, h.condition, h.substitute):
        with pytest.raises(ReproError, match="RPL008"):
            h.trace(handler(enum(discrete, first_available_dim=-1),
                            data={"z": torch.tensor(1)})).get_trace()


# ---------------------------------------------------------------------------
# subsample
# ---------------------------------------------------------------------------

def test_subsample_matches_reference_with_pinned_indices():
    ours, theirs = _pair(_sub_model)
    idx = np.array([9, 8, 7, 6])
    for dtype in (np.float32,):
        lp, tr = log_density(ours, (torch.from_numpy(X),),
                             {"y": torch.from_numpy(Y)},
                             {"w": torch.tensor(1.5),
                              "N": torch.from_numpy(idx)})
        jlp, jtr = j_log_density(theirs, (jnp.asarray(X),),
                                 {"y": jnp.asarray(Y)},
                                 {"w": jnp.asarray(1.5),
                                  "N": jnp.asarray(idx)})
        assert_same_trace(tr, jtr)
        assert abs(float(lp) - float(jlp)) <= 1e-5 * abs(float(jlp))
        assert tr["obs"]["scale"] == pytest.approx(2.5)


def test_subsample_shapes_and_random_indices():
    def m2(P, D, A, x2d):
        with P.plate("N", 10, subsample_size=4) as idx:
            return idx, P.subsample(x2d, event_dim=1)

    ours, _ = _pair(m2)
    x2d = torch.arange(30.0).reshape(10, 3)
    idx, out = h.seed(ours, 0)(x2d)
    assert out.shape == (4, 3) and torch.equal(out, x2d[idx])
    assert len(set(idx.tolist())) == 4
    idx2, _ = h.seed(ours, 0)(x2d)
    idx3, _ = h.seed(ours, 1)(x2d)
    assert torch.equal(idx, idx2) and not torch.equal(idx, idx3)

    def passthrough(xb):
        with pc.plate("N", 10, subsample_size=4):
            return pc.subsample(xb)

    assert torch.equal(h.seed(passthrough, 0)(torch.arange(4.0)),
                       torch.arange(4.0))
    assert torch.equal(h.seed(passthrough, 0)(torch.ones(3, 1)),
                       torch.ones(3, 1))  # the plate's dim has extent 1
    with pytest.raises(ReproError, match="RPL004"):
        h.seed(passthrough, 0)(torch.arange(7.0))
    assert pc.subsample(torch.arange(3.0)) is not None  # outside handlers

    def outside_dims():
        with pc.plate("N", 10, subsample_size=4, dim=-2):
            return pc.subsample(torch.arange(10.0))

    # the data does not span the plate's dim: passed through unchanged
    assert torch.equal(h.seed(outside_dims, 0)(), torch.arange(10.0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, tr = log_density(_pair(_sub_model)[0], (torch.from_numpy(X),),
                            {"y": torch.from_numpy(Y)},
                            {"w": torch.tensor(2.0)})
    assert any("subsampled plate" in str(w.message) for w in caught)
    assert torch.equal(tr["N"]["value"], torch.arange(4))


# ---------------------------------------------------------------------------
# reparam
# ---------------------------------------------------------------------------

def _funnel(P, D, A):
    mu = P.sample("mu", D.Normal(0.0, 3.0))
    tau = P.sample("tau", D.HalfNormal(3.0))
    with P.plate("J", 5):
        theta = P.sample("theta", D.Normal(mu, tau))
    return theta


EPS = (np.arange(5.0) / 3 - 0.5).astype(np.float32)


@pytest.mark.parametrize("centered", [0.0, 0.5, 1.0])
def test_loc_scale_reparam_matches_reference_and_keeps_density(centered):
    ours, theirs = _pair(_funnel)
    rep = h.reparam(ours, config={"theta": LocScaleReparam(centered)})
    jrep = jh.reparam(theirs, config={
        "theta": jreparam.LocScaleReparam(centered)})
    name = "theta" if centered == 1.0 else "theta_decentered"
    params = {"mu": 0.7, "tau": 1.3, name: EPS}
    lp, tr = log_density(rep, (), {}, {k: torch.as_tensor(v)
                                       for k, v in params.items()})
    jlp, jtr = j_log_density(jrep, (), {}, {k: jnp.asarray(v)
                                            for k, v in params.items()})
    assert_same_trace(tr, jtr)
    assert abs(float(lp) - float(jlp)) < 1e-5
    if centered == 0.0:
        assert tr["theta"]["type"] == "deterministic"
        assert tr["theta"]["infer"]["reparamed"]
        theta = tr["theta"]["value"]
        np.testing.assert_allclose(theta.numpy(), 0.7 + 1.3 * EPS,
                                   rtol=1e-6)
        lp_c, _ = log_density(ours, (), {}, {"mu": torch.tensor(0.7),
                                             "tau": torch.tensor(1.3),
                                             "theta": theta})
        # the change of variables: |d theta / d eps| = tau^5
        assert abs(float(lp) - (float(lp_c) + 5 * np.log(1.3))) < 1e-4


def test_transform_reparam_matches_reference_and_keeps_density():
    loc, scale = np.array([0.5, -1.0], np.float32), np.array([2.0, 0.5],
                                                             np.float32)

    def model(P, D, A):
        return P.sample("x", D.TransformedDistribution(
            D.Normal(0.0, 1.0), [D.AffineTransform(A(loc), A(scale)),
                                 D.transforms.ExpTransform()]))

    ours, theirs = _pair(model)
    base = np.array([0.3, -0.2], np.float32)
    lp, tr = log_density(h.reparam(ours, config={"x": TransformReparam()}),
                         (), {}, {"x_base": torch.from_numpy(base)})
    jlp, jtr = j_log_density(
        jh.reparam(theirs, config={"x": jreparam.TransformReparam()}), (), {},
        {"x_base": jnp.asarray(base)})
    assert_same_trace(tr, jtr)
    assert abs(float(lp) - float(jlp)) < 1e-5
    np.testing.assert_allclose(tr["x"]["value"].numpy(),
                               np.exp(loc + scale * base), rtol=1e-6)
    # the base density is the transformed one plus the log-Jacobian
    x = tr["x"]["value"]
    lp_t, _ = log_density(ours, (), {}, {"x": x})
    jac = np.sum(np.log(np.abs(scale)) + loc + scale * base)
    assert abs(float(lp) - (float(lp_t) + jac)) < 1e-4


def test_reparam_guards_like_reference():
    ours, _ = _pair(_funnel)

    def observed():
        pc.sample("z", dist.Normal(0.0, 1.0), obs=torch.tensor(0.5))

    for strategy in (LocScaleReparam(0.0), TransformReparam()):
        with pytest.raises(ValueError, match="observed site"):
            h.trace(h.reparam(observed, config={"z": strategy})).get_trace()
    with pytest.raises(ValueError, match="substituted/replayed value"):
        h.trace(h.seed(h.reparam(h.substitute(ours, {"theta": torch.zeros(5)}),
                                 config={"theta": LocScaleReparam(0.0)}),
                       0)).get_trace()
    with pytest.raises(ValueError, match="TransformedDistribution"):
        h.trace(h.seed(h.reparam(ours, config={"mu": TransformReparam()}),
                       0)).get_trace()
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        LocScaleReparam(1.5)
    with pytest.raises(ValueError, match="config"):
        h.reparam(ours)
    # a broad callable config does not reparameterize its own auxiliaries
    tr = h.trace(h.seed(h.reparam(ours, config=lambda msg: LocScaleReparam(
        0.0) if msg["name"] != "tau" else None), 0)).get_trace()
    assert list(tr) == ["mu_decentered", "mu", "tau", "theta_decentered",
                        "theta"]


# ---------------------------------------------------------------------------
# Predictive / log_likelihood / initialization
# ---------------------------------------------------------------------------

SCHOOLS = eight_schools_data()


def _j_eight_schools(sigma, y=None):
    mu = jpc.sample("mu", jdist.Normal(0.0, 5.0))
    tau = jpc.sample("tau", jdist.HalfCauchy(5.0))
    with jpc.plate("J", sigma.shape[0]):
        theta = jpc.sample("theta", jdist.Normal(mu, tau))
        jpc.sample("obs", jdist.Normal(theta, sigma), obs=y)
    return theta


NC_PORT = h.reparam(eight_schools, config={"theta": LocScaleReparam(0.0)})
NC_REF = jh.reparam(_j_eight_schools,
                    config={"theta": jreparam.LocScaleReparam(0.0)})


def _pinned_draws(num=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"mu": rng.normal(4.0, 2.0, num).astype(np.float32),
            "tau": rng.uniform(0.5, 4.0, num).astype(np.float32),
            "theta_decentered": rng.standard_normal((num, 8)).astype(
                np.float32)}


def test_predictive_matches_reference_on_pinned_draws():
    draws = _pinned_draws()
    sigma = torch.from_numpy(SCHOOLS["sigma"])
    out = Predictive(NC_PORT, {k: torch.from_numpy(v)
                               for k, v in draws.items()})(0, sigma)
    jout = JPredictive(NC_REF, {k: jnp.asarray(v) for k, v in draws.items()})(
        jax.random.PRNGKey(0), jnp.asarray(SCHOOLS["sigma"]))
    assert set(out) == set(jout) == {"theta", "obs"}
    np.testing.assert_allclose(out["theta"].numpy(), np.asarray(jout["theta"]),
                               rtol=1e-6, atol=1e-5)
    assert out["obs"].shape == jout["obs"].shape == (6, 8)
    # the same seed gives the same draws, another seed others
    again = Predictive(NC_PORT, {k: torch.from_numpy(v)
                                 for k, v in draws.items()})(0, sigma)
    other = Predictive(NC_PORT, {k: torch.from_numpy(v)
                                 for k, v in draws.items()})(1, sigma)
    assert torch.equal(again["obs"], out["obs"])
    assert not torch.equal(other["obs"], out["obs"])
    # obs ~ Normal(theta, sigma): standardized residuals are N(0, 1)
    many = _pinned_draws(num=400, seed=1)
    big = Predictive(NC_PORT, {k: torch.from_numpy(v)
                               for k, v in many.items()})(2, sigma)
    z = ((big["obs"] - big["theta"]) / sigma).numpy()
    assert abs(z.mean()) < 4 / np.sqrt(z.size)
    assert abs(z.var() - 1.0) < 4 * np.sqrt(2 / z.size)


def test_predictive_chain_grouped_prior_and_errors():
    draws = {k: torch.from_numpy(v.reshape((2, 3) + v.shape[1:]))
             for k, v in _pinned_draws().items()}
    sigma = torch.from_numpy(SCHOOLS["sigma"])
    out = Predictive(NC_PORT, draws, batch_ndims=2,
                     return_sites=["theta"])(0, sigma)
    assert list(out) == ["theta"] and out["theta"].shape == (2, 3, 8)
    prior = Predictive(NC_PORT, num_samples=5)(0, sigma)
    jprior = JPredictive(NC_REF, num_samples=5)(
        jax.random.PRNGKey(0), jnp.asarray(SCHOOLS["sigma"]))
    assert set(prior) == set(jprior)
    assert all(prior[k].shape == jprior[k].shape for k in prior)
    with pytest.raises(ValueError, match="return_sites"):
        Predictive(NC_PORT, num_samples=2, return_sites=["nope"])(0, sigma)
    with pytest.raises(ValueError, match="ambiguous"):
        Predictive(NC_PORT, draws, num_samples=3)
    with pytest.raises(ValueError, match="need posterior_samples"):
        Predictive(NC_PORT)
    with pytest.raises(ValueError, match="batch_ndims"):
        Predictive(NC_PORT, num_samples=2, batch_ndims=3)


def test_log_likelihood_matches_reference_on_pinned_draws():
    draws = _pinned_draws()
    ll = log_likelihood(NC_PORT, {k: torch.from_numpy(v)
                                  for k, v in draws.items()},
                        torch.from_numpy(SCHOOLS["sigma"]),
                        y=torch.from_numpy(SCHOOLS["y"]))
    jll = j_log_likelihood(NC_REF, {k: jnp.asarray(v)
                                    for k, v in draws.items()},
                           jnp.asarray(SCHOOLS["sigma"]),
                           y=jnp.asarray(SCHOOLS["y"]))
    assert set(ll) == set(jll) == {"obs"}
    np.testing.assert_allclose(ll["obs"].numpy(), np.asarray(jll["obs"]),
                               rtol=1e-6, atol=1e-5)

    # Predictive's output (deterministic sites included) round-trips
    def m(x, y=None):
        w = pc.sample("w", dist.Normal(0.0, 1.0))
        pc.deterministic("w2", w ** 2)
        pc.sample("y", dist.Normal(w * x, 1.0), obs=y)

    x = torch.arange(4.0)
    out = Predictive(m, num_samples=5)(0, x)
    assert "w2" in out
    assert log_likelihood(m, out, x, y=torch.zeros(4))["y"].shape == (5, 4)


def test_log_likelihood_requires_pinned_discrete_latents():
    def mix(x):
        mu = pc.sample("mu", dist.Normal(torch.zeros(2), 1.0).to_event(1))
        with pc.plate("data", x.shape[0]):
            z = pc.sample("z", dist.Categorical(probs=torch.tensor([.4, .6])))
            pc.sample("obs", dist.Normal(mu[z], 1.0), obs=x)

    x = torch.tensor([0.5, -1.0, 2.0])
    draws = {"mu": torch.tensor([[0.0, 1.0], [0.5, -0.5]])}
    with pytest.raises(NotImplementedError, match="infer_discrete"):
        log_likelihood(mix, draws, x)
    pinned = dict(draws, z=torch.tensor([[0, 1, 1], [1, 0, 0]]))
    ll = log_likelihood(mix, pinned, x)
    want = dist.Normal(draws["mu"][0][pinned["z"][0]], 1.0).log_prob(x)
    assert torch.allclose(ll["obs"][0], want)


def test_initialize_model_and_constrain_fn_match_reference():
    sigma, y = SCHOOLS["sigma"], SCHOOLS["y"]
    (z, pot, unravel, transforms, constrain,
     tr) = initialize_model(torch.Generator().manual_seed(0), NC_PORT,
                            (torch.from_numpy(sigma),),
                            {"y": torch.from_numpy(y)})
    (jz, jpot, junravel, jtransforms, _, _) = j_initialize_model(
        jax.random.PRNGKey(0), NC_REF, (jnp.asarray(sigma),),
        {"y": jnp.asarray(y)})
    assert z.shape == jz.shape == (10,)
    assert bool(torch.isfinite(pot(z)))
    # the same unconstrained point means the same constrained values
    u = np.random.default_rng(0).uniform(-2, 2, 10).astype(np.float32)
    ours = constrain_fn(NC_PORT, (), {}, transforms,
                        unravel(torch.from_numpy(u)))
    theirs = j_constrain_fn(NC_REF, (), {}, jtransforms,
                            junravel(jnp.asarray(u)))
    assert set(ours) == set(theirs) == {"mu", "tau", "theta_decentered"}
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(pot(torch.from_numpy(u))),
                               float(jpot(jnp.asarray(u))), rtol=1e-5)


def test_prior_init_strategy():
    sigma = torch.from_numpy(SCHOOLS["sigma"])
    kwargs = {"y": torch.from_numpy(SCHOOLS["y"])}
    gen = torch.Generator().manual_seed(3)
    z, pot, _, transforms, constrain, _ = initialize_model(
        gen, NC_PORT, (sigma,), kwargs, init_strategy="prior")
    # the proposal is a prior draw: theta_decentered (the last 8 of the
    # sorted sites mu, tau, theta_decentered) looks standard normal, not
    # uniform on [-2, 2]
    assert bool(torch.isfinite(pot(z)))
    from repro_torch.core.infer import GeneratorDraws
    from repro_torch.core.infer.util import prior_init
    propose = prior_init(NC_PORT, (sigma,), kwargs, transforms)
    draws = torch.stack([propose(GeneratorDraws(
        torch.Generator().manual_seed(s))) for s in range(300)])
    dec = draws[:, 2:]
    assert abs(float(dec.std()) - 1.0) < 0.1
    assert float(dec.abs().max()) > 2.0
    # the reference's prior init: the same flat layout, a finite potential
    jz, jpot = j_initialize_model(
        jax.random.PRNGKey(3), NC_REF, (jnp.asarray(SCHOOLS["sigma"]),),
        {"y": jnp.asarray(SCHOOLS["y"])}, init_strategy="prior")[:2]
    assert jz.shape == z.shape and bool(jnp.isfinite(jpot(jz)))
    # the port's potential at the reference's prior point is the reference's
    np.testing.assert_allclose(float(pot(torch.from_numpy(np.asarray(jz)))),
                               float(jpot(jz)), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown init strategy"):
        initialize_model(gen, NC_PORT, (sigma,), kwargs,
                         init_strategy="median")
    m = MCMC(NUTS(NC_PORT, init_strategy="prior", device="cpu"), 20, 5)
    m.run(0, SCHOOLS["sigma"], y=SCHOOLS["y"])
    assert m.get_samples()["tau"].shape == (5,)


def test_eight_schools_noncentered_posterior_matches_reference():
    """Level 3 at the example's setting (``examples/eight_schools.py:43``):
    4 chains of 150 + 200, split R-hat < 1.05 on every site, posterior means
    of mu, log tau and theta_decentered within 4 Monte Carlo standard errors
    of the reference's; then Predictive of obs at (800, 8)."""
    sigma, y = SCHOOLS["sigma"], SCHOOLS["y"]
    m = MCMC(NUTS(NC_PORT, device="cpu"), num_warmup=150, num_samples=200,
             num_chains=4, chain_method="sequential")
    m.run(0, sigma, y=y)
    jm = JMCMC(JNUTS(NC_REF), num_warmup=150, num_samples=200, num_chains=4)
    jm.run(jax.random.PRNGKey(0), jnp.asarray(sigma), y=jnp.asarray(y))
    ours = m.get_samples(group_by_chain=True)
    theirs = jm.get_samples(group_by_chain=True)
    for name in ("mu", "tau", "theta_decentered"):
        a, b = ours[name].numpy(), np.asarray(theirs[name])
        assert np.max(gelman_rubin(a)) < 1.05, name
        if name == "tau":
            a, b = np.log(a), np.log(b)
        se = np.sqrt(a.std((0, 1)) ** 2 / effective_sample_size(a)
                     + b.std((0, 1)) ** 2 / effective_sample_size(b))
        assert np.all(np.abs(a.mean((0, 1)) - b.mean((0, 1))) <= 4 * se), \
            name
    post = Predictive(NC_PORT, m.get_samples())(1, torch.from_numpy(sigma))
    assert post["obs"].shape == (800, 8)
    assert bool(torch.isfinite(post["obs"]).all())


# ---------------------------------------------------------------------------
# strict handlers leave the stack clean when their check raises
# ---------------------------------------------------------------------------

def _one_site(P, D, A):
    P.sample("a", D.Normal(0.0, 1.0))


@pytest.mark.parametrize("handler", ["substitute", "condition", "do"])
def test_strict_handler_pops_before_it_raises(handler):
    """A strict ``substitute``/``condition``/``do`` whose data key matches
    no site raises RPL006, as the reference does, and is off the handler
    stack afterwards: later model runs are not substituted."""
    from repro.core import primitives as jprim
    from repro.core.errors import ReproError as JReproError
    from repro_torch.core import primitives as prim
    ours, theirs = _pair(_one_site)
    with pytest.raises(ReproError) as err:
        getattr(h, handler)(h.seed(ours, 0), data={"nope": torch.tensor(1.0)},
                            strict=True)()
    assert prim._STACK == []
    try:
        with pytest.raises(JReproError) as jerr:
            getattr(jh, handler)(jh.seed(theirs, 0),
                                 data={"nope": jnp.asarray(1.0)},
                                 strict=True)()
    finally:
        jprim._STACK.clear()  # the reference keeps the handler on its stack
    assert err.value.code == jerr.value.code == "RPL006"
    assert err.value.site == jerr.value.site == "nope"
    # the next run draws freely: nothing substituted behind its back
    tr = h.trace(h.seed(ours, 1)).get_trace()
    assert not tr["a"]["is_observed"] and prim._STACK == []
