"""The port's model layer against the JAX package: handler semantics (a
subset of tests/test_handlers.py), log densities, the flat potential and its
autograd gradient against ``jax.value_and_grad``, and the fused GLM
potential against the plain one.  Inputs are made with numpy from a seed."""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jpc
from benchmarks.models import logreg_model as j_logreg
from repro.core import dist as jdist
from repro.core.infer import initialize_model_structure as j_init_structure
from repro_torch import core as pc
from repro_torch.bench.models import logreg_model, logreg_model_glm
from repro_torch.core import dist
from repro_torch.core.errors import KERNEL_MISMATCH, ReproError
from repro_torch.core.handlers import block, condition, seed, substitute, trace
from repro_torch.core.infer import (MCMC, NUTS, initialize_model_structure,
                                    log_density)
from repro_torch.core.infer.hmc_util import value_and_grad
from repro_torch.core.primitives import stack
from repro_torch.kernels import ops


def model(x=None):
    z = pc.sample("z", dist.Normal(0.0, 1.0))
    w = pc.sample("w", dist.Normal(z, 1.0))
    return pc.sample("obs", dist.Normal(w, 1.0), obs=x)


# --- handlers ----------------------------------------------------------------

def test_seed_deterministic():
    a = seed(model, 0)()
    b = seed(model, 0)()
    c = seed(model, 1)()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_seed_draws_per_site():
    tr = trace(seed(model, 0)).get_trace()
    assert float(tr["z"]["value"]) != float(tr["w"]["value"])


def test_trace_records_all_sites():
    tr = trace(seed(model, 0)).get_trace(torch.tensor(1.0))
    assert list(tr) == ["z", "w", "obs"]
    assert tr["obs"]["is_observed"] and not tr["z"]["is_observed"]


def test_condition_observes():
    tr = trace(seed(condition(model, {"z": torch.tensor(2.0)}), 0)).get_trace()
    assert tr["z"]["is_observed"] and float(tr["z"]["value"]) == 2.0


def test_substitute_stays_latent():
    tr = trace(seed(substitute(model, {"z": torch.tensor(2.0)}),
                    0)).get_trace()
    assert not tr["z"]["is_observed"] and float(tr["z"]["value"]) == 2.0


def test_block():
    tr = trace(block(seed(model, 0), hide=["z"])).get_trace()
    assert "z" not in tr and "w" in tr


def test_unseeded_sample_raises_coded():
    with pytest.raises(ValueError, match="RPL009"):
        model()


def test_duplicate_site_raises_coded():
    def twice():
        pc.sample("a", dist.Normal(0.0, 1.0))
        pc.sample("a", dist.Normal(0.0, 1.0))

    with pytest.raises(ReproError, match="RPL001"):
        trace(seed(twice, 0)).get_trace()


def test_exception_unwinds_stack():
    def bad():
        pc.sample("z", dist.Normal(0.0, 1.0))
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        seed(bad, 0)()
    assert len(stack()) == 0


def test_plate_expands_and_scales_like_reference():
    def m():
        with pc.plate("N", 10, subsample_size=5):
            return pc.sample("x", dist.Normal(0.0, 1.0))

    assert seed(m, 0)().shape == (5,)
    lp, _ = log_density(seed(m, 0), (), {}, {"x": torch.zeros(5)})

    def jm():
        with jpc.plate("N", 10, subsample_size=5):
            return jpc.sample("x", jdist.Normal(0.0, 1.0))

    from repro.core.handlers import seed as jseed
    from repro.core.infer import log_density as j_log_density
    jlp, _ = j_log_density(jseed(jm, jax.random.PRNGKey(0)), (), {},
                           {"x": jnp.zeros(5)})
    np.testing.assert_allclose(float(lp), float(jlp), rtol=1e-6)


def test_plate_observed_shape_mismatch_raises_coded():
    def m():
        with pc.plate("N", 4):
            pc.sample("x", dist.Normal(0.0, 1.0), obs=torch.zeros(3))

    with pytest.raises(ReproError, match="RPL004"):
        trace(m).get_trace()


def test_observed_outside_support_raises_coded():
    def m():
        pc.sample("y", dist.Bernoulli(logits=torch.zeros(2)),
                  obs=torch.tensor([0.0, 2.0]))

    with pytest.raises(ReproError, match="RPL005"):
        trace(m).get_trace()


# --- distributions -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_normal_bernoulli_independent_log_prob_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    loc, v = rng.standard_normal((2,) + shape).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    probs = rng.uniform(0.05, 0.95, shape).astype(np.float32)
    obs = (rng.random(shape) < 0.5).astype(np.float32)
    t = torch.as_tensor
    pairs = [
        (dist.Normal(t(loc), t(scale)).log_prob(t(v)),
         jdist.Normal(loc, scale).log_prob(v)),
        (dist.Bernoulli(logits=t(logits)).log_prob(t(obs)),
         jdist.Bernoulli(logits=logits).log_prob(obs)),
        (dist.Bernoulli(probs=t(probs)).log_prob(t(obs)),
         jdist.Bernoulli(probs=probs).log_prob(obs)),
    ]
    if shape:
        pairs.append((dist.Normal(t(loc), t(scale)).to_event(1).log_prob(t(v)),
                      jdist.Normal(loc, scale).to_event(1).log_prob(v)))
        pairs.append((dist.Normal(t(loc), t(scale)).expand((2,) + shape)
                      .log_prob(t(v)),
                      jdist.Normal(loc, scale).expand((2,) + shape)
                      .log_prob(v)))
    for ours, ref in pairs:
        assert tuple(ours.shape) == tuple(jnp.shape(ref))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_independent_and_expanded_shapes():
    base = dist.Normal(torch.zeros(3), torch.ones(3))
    ind = base.to_event(1)
    assert ind.batch_shape == () and ind.event_shape == (3,)
    assert ind.expand((5,)).batch_shape == (5,)
    exp = dist.ExpandedDistribution(base, (2, 3))
    assert exp.sample(torch.Generator().manual_seed(0)).shape == (2, 3)


# --- the flat potential ------------------------------------------------------

def _logreg_inputs(n=300, d=4, seed_=0):
    rng = np.random.default_rng(seed_)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.5 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return x, y


def test_potential_and_grad_match_jax_value_and_grad():
    x, y = _logreg_inputs()
    pot = initialize_model_structure(None, logreg_model, (torch.from_numpy(x),),
                                     {"y": torch.from_numpy(y)})[0]
    jpot = j_init_structure(jax.random.PRNGKey(0), j_logreg, (jnp.asarray(x),),
                            {"y": jnp.asarray(y)})[0]
    rng = np.random.default_rng(5)
    for _ in range(3):
        z = (0.5 * rng.standard_normal(x.shape[1])).astype(np.float32)
        pe, g = value_and_grad(pot)(torch.from_numpy(z))
        jpe, jg = jax.value_and_grad(jpot)(jnp.asarray(z))
        np.testing.assert_allclose(float(pe), float(jpe), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def _nonaffine(x, y=None):
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Bernoulli(logits=x @ torch.tanh(w)), obs=y,
                     infer={"potential": "glm"})


def _probs_glm(x, y=None):
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Bernoulli(probs=torch.sigmoid(x @ w)), obs=y,
                     infer={"potential": "glm"})


def _normal_glm(x, y=None, glm=True):
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Normal(x @ w + 1.0, 0.3).to_event(1), obs=y,
                     infer={"potential": "glm"} if glm else None)


def test_fused_glm_matches_plain_and_jax():
    x, y = _logreg_inputs()
    args, kw = (torch.from_numpy(x),), {"y": torch.from_numpy(y)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # no fallback
        fused = initialize_model_structure(None, logreg_model_glm, args, kw)[0]
    plain = initialize_model_structure(None, logreg_model, args, kw)[0]
    jpot = j_init_structure(jax.random.PRNGKey(0), j_logreg, (jnp.asarray(x),),
                            {"y": jnp.asarray(y)})[0]
    z = torch.from_numpy((0.3 * np.arange(x.shape[1])).astype(np.float32))
    v1, g1 = value_and_grad(fused)(z)
    v2, g2 = value_and_grad(plain)(z)
    jv, jg = jax.value_and_grad(jpot)(jnp.asarray(z.numpy()))
    for v, g in ((v2, g2), (jv, jg)):
        np.testing.assert_allclose(float(v1), float(v), rtol=1e-5)
        np.testing.assert_allclose(g1.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4)


def test_fused_glm_normal_family_with_offset_matches_plain():
    x, _ = _logreg_inputs(200, 3, 7)
    y = (x @ np.array([0.5, -1.0, 0.2], np.float32) + 1.0).astype(np.float32)
    args, kw = (torch.from_numpy(x),), {"y": torch.from_numpy(y)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        fused = initialize_model_structure(None, _normal_glm, args, kw)[0]
    plain = initialize_model_structure(None, _normal_glm, args,
                                       dict(kw, glm=False))[0]
    z = torch.tensor([0.1, 0.2, -0.3])
    v1, g1 = value_and_grad(fused)(z)
    v2, g2 = value_and_grad(plain)(z)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bad,reason", [(_nonaffine, "not affine"),
                                        (_probs_glm, "probs-parametrized")])
def test_fused_glm_falls_back_with_warning(bad, reason):
    x, y = _logreg_inputs(100, 3, 9)
    args, kw = (torch.from_numpy(x),), {"y": torch.from_numpy(y)}
    with pytest.warns(UserWarning, match=reason):
        pot = initialize_model_structure(None, bad, args, kw)[0]
    # the plain potential, exactly
    z = torch.tensor([0.3, -0.2, 0.1])
    tr_lp, _ = log_density(bad, args, kw, {"w": z})
    np.testing.assert_allclose(float(pot(z)), -float(tr_lp), rtol=1e-6)


@pytest.mark.parametrize("fault", ["raises", "disagrees"])
def test_fused_glm_kernel_fault_raises_not_falls_back(monkeypatch, fault):
    """A fault of the fused term is never masked by a fallback: an error of
    the kernel's wrapper propagates out of ``MCMC.run``, and a disagreement
    with the plain potential raises RPL503."""
    real = ops.glm_potential_grad

    def broken(*args):
        if fault == "raises":
            raise RuntimeError("glm_potential_grad: launch failed")
        val, grad = real(*args)
        return val + 1.0, grad

    monkeypatch.setattr(ops, "glm_potential_grad", broken)
    x, y = _logreg_inputs(100, 3, 9)
    mcmc = MCMC(NUTS(logreg_model_glm, device="cpu"), num_warmup=2,
                num_samples=2)
    err, match = ((RuntimeError, "launch failed") if fault == "raises"
                  else (ReproError, KERNEL_MISMATCH))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # no fallback
        with pytest.raises(err, match=match):
            mcmc.run(0, x, y=y)


def _data_dependent_prior(x, y=None):
    d = x.shape[-1]
    s = 1.0 + x.abs().mean()  # nan on 0 rows
    w = pc.sample("w", dist.Normal(x.new_zeros(d), s * x.new_ones(d))
                  .to_event(1))
    return pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
                     infer={"potential": "glm"})


def test_fused_glm_prior_path_is_reported():
    """The prior term runs on data cut to 0 rows where that leaves it
    unchanged; elsewhere on the full data, with a warning."""
    x, y = _logreg_inputs(100, 3, 9)
    args, kw = (torch.from_numpy(x),), {"y": torch.from_numpy(y)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        pot = initialize_model_structure(None, logreg_model_glm, args, kw)[0]
    assert pot.glm_prior == "slim"
    with pytest.warns(UserWarning, match="full arguments"):
        pot = initialize_model_structure(None, _data_dependent_prior, args,
                                         kw)[0]
    assert pot.glm_prior == "full"
    z = torch.tensor([0.3, -0.2, 0.1])
    tr_lp, _ = log_density(_data_dependent_prior, args, kw, {"w": z})
    np.testing.assert_allclose(float(pot(z)), -float(tr_lp), rtol=1e-5)


def test_discrete_latent_raises_pending():
    """A latent discrete site is marginalized (it is no continuous latent)
    and, since the discrete-posterior slice, sampled from its posterior
    by ``infer_discrete`` and ``enum`` in sample mode: neither raises the
    pending-feature error any more."""
    from repro_torch.core.infer import (config_enumerate, enum,
                                        infer_discrete)
    from repro_torch.core.infer.hmc_util import GeneratorDraws

    def m():
        pc.sample("c", dist.Bernoulli(probs=torch.tensor(0.5)))
        pc.sample("x", dist.Normal(0.0, 1.0))

    transforms = initialize_model_structure(None, m)[2]
    assert list(transforms) == ["x"]
    pinned = substitute(m, data={"x": torch.tensor(0.3)})
    draws = infer_discrete(pinned, torch.Generator().manual_seed(0),
                           device="cpu")()
    assert set(draws) == {"c"} and float(draws["c"]) in (0.0, 1.0)
    handler = enum(config_enumerate(pinned), first_available_dim=-1,
                   mode="sample", draws=GeneratorDraws(torch.Generator()))
    with handler:
        tr = trace(handler.fn).get_trace()
    assert tr["c"]["infer"]["_enumerate_dim"] == -1
    assert tuple(tr["c"]["value"].shape) == (2,)


def test_port_imports_no_jax():
    """The port imports torch and numpy, never jax nor the repro package."""
    code = ("import sys; import repro_torch.core.infer, repro_torch.interop, "
            "repro_torch.bench.models, repro_torch.kernels.ops, "
            "repro_torch.core.infer.enum, repro_torch.kernels.enum_contract, "
            "repro_torch.models, repro_torch.launch.serve, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.softmax_xent, repro_torch.optim, "
            "repro_torch.core.bayes, repro_torch.data, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.distributed, repro_torch.distributed.checkpoint, "
            "repro_torch.core.infer.svi, repro_torch.core.infer.autoguide, "
            "repro_torch.obs, repro_torch.obs.compare, "
            "repro_torch.obs.validate, repro_torch.lint_rules, "
            "repro_torch.lint_rules.obs_rules, repro_torch.core.lint, "
            "repro_torch.lint, repro_torch.lint.__main__, "
            "repro_torch.lint_rules.invariants, "
            "repro_torch.optim.compression, repro_torch.launch.mesh, "
            "repro_torch.distributed.sharding, repro_torch.bench.lm_mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')];"
            " assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH="src"))
