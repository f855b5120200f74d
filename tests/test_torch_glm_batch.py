"""The GLM potential over the chains of an ensemble: ``w (C, d)``.

- The batched plain version against ``jax.vmap`` of the JAX reference
  ``repro.kernels.ref.glm_potential_grad`` over ``w`` (and once against
  ``jax.vmap`` of the Pallas kernel in interpret mode), at C in {1, 3, 8},
  both families, offset on and off, within ``TOL["glm_potential_grad"]``;
  chain c of a batched call equals a single call on ``w[c]`` bit for bit.
- The fused potential's batched entry (``value_and_grad_batch``) on a small
  ``logreg_model_glm``: ``chain_value_and_grad`` of the counted potential
  equals the per-chain loop bit for bit and agrees with the reference's
  ``chain_vmap(jax.value_and_grad(potential))`` within the ensemble tests'
  tolerances; the count goes up by C a call; an ensemble run reports
  ``glm_prior_batch == "vmap"``; a prior that ``vmap`` cannot trace runs
  as a loop, with a warning, and still matches.

The reference's ensemble paths import ``repro._compat``'s batch rule, which
breaks on jax 0.9.0; the fixture below replaces it with a no-op in this
test process only, as ``tests/test_torch_ensemble.py`` does.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro._compat
from benchmarks.models import logreg_model as j_logreg
from repro.core.infer import hmc_util as jhu
from repro.core.infer import initialize_model_structure as j_init_structure
from repro.kernels import ref as jref
from repro.kernels.glm_potential import glm_potential_grad as j_glm_pallas
from repro_torch import core as pc
from repro_torch.bench.models import logreg_model_glm
from repro_torch.core import dist
from repro_torch.core.infer import MALA, MCMC, initialize_model_structure
from repro_torch.core.infer import hmc_util as hu
from repro_torch.core.infer.hmc import counting
from repro_torch.kernels import ops
from repro_torch.kernels.glm_potential import (MAX_CHAINS,
                                               glm_potential_grad_cuda,
                                               glm_potential_grad_ref)

TOL = ops.SPECS["glm_potential_grad"].tol


@pytest.fixture(autouse=True)
def _reference_on_jax_0_9(monkeypatch):
    monkeypatch.setattr(repro._compat,
                        "ensure_optimization_barrier_batch_rule",
                        lambda: None)


def _inputs(n, d, chains, seed, family):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((chains, d))).astype(np.float32)
    off = (0.2 * rng.standard_normal(n)).astype(np.float32)
    if family == "bernoulli_logit":
        y = (rng.random(n) < 0.5).astype(np.float32)
    else:
        y = (x @ w[0] + 0.5 * rng.standard_normal(n)).astype(np.float32)
    return x, y, w, off


FAMILIES = [("bernoulli_logit", None), ("normal", 0.7)]


@pytest.mark.parametrize("family,scale", FAMILIES)
@pytest.mark.parametrize("use_offset", [False, True])
@pytest.mark.parametrize("chains", [1, 3, 8])
def test_batched_plain_matches_vmapped_reference(family, scale, use_offset,
                                                 chains):
    x, y, w, off = _inputs(1001, 7, chains, chains, family)
    off = off if use_offset else None
    t = [None if a is None else torch.from_numpy(a) for a in (x, y, w, off)]
    nll, grad = ops.glm_potential_grad(t[0], t[1], t[2], t[3], scale, family)
    assert nll.shape == (chains,) and grad.shape == (chains, 7)
    joff = None if off is None else jnp.asarray(off)
    jv, jg = jax.vmap(
        lambda wc: jref.glm_potential_grad(jnp.asarray(x), jnp.asarray(y), wc,
                                           joff, scale, family))(
        jnp.asarray(w))
    np.testing.assert_allclose(nll.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=0,
                               atol=TOL)
    for c in range(chains):  # each chain is a single call, bit for bit
        v1, g1 = ops.glm_potential_grad(t[0], t[1], t[2][c], t[3], scale,
                                        family)
        assert torch.equal(nll[c], v1) and torch.equal(grad[c], g1)


@pytest.mark.parametrize("family,scale", FAMILIES)
def test_batched_plain_matches_vmapped_pallas_kernel(family, scale):
    x, y, w, off = _inputs(301, 5, 3, 11, family)
    t = [torch.from_numpy(a) for a in (x, y, w, off)]
    nll, grad = ops.glm_potential_grad(*t, scale, family)
    jv, jg = jax.vmap(
        lambda wc: j_glm_pallas(jnp.asarray(x), jnp.asarray(y), wc,
                                jnp.asarray(off), scale, family,
                                interpret=True))(jnp.asarray(w))
    np.testing.assert_allclose(nll.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), rtol=0,
                               atol=TOL)


def test_batched_float64_weights_come_back_float64():
    x, y, w, _ = _inputs(50, 4, 3, 2, "bernoulli_logit")
    nll, grad = glm_potential_grad_ref(torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.from_numpy(w).double())
    assert nll.dtype == grad.dtype == torch.float64
    assert nll.shape == (3,) and grad.shape == (3, 4)


def test_cuda_wrapper_refuses_cpu_and_bad_chains():
    x, y, w, _ = _inputs(10, 3, 2, 0, "bernoulli_logit")
    with pytest.raises(ValueError, match="CUDA"):
        glm_potential_grad_cuda(torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(w))
    assert MAX_CHAINS == 256


def _logreg(n=300, d=4, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.7 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return x, y


def _loop(pot, z):
    pe_and_grad = hu.value_and_grad(pot)
    pes, grads = zip(*(pe_and_grad(row) for row in z))
    return torch.stack(pes), torch.stack(grads)


@pytest.mark.parametrize("chains", [1, 3, 8])
def test_chain_value_and_grad_is_one_batched_call(chains):
    """Bit for bit the per-chain loop, within the ensemble tests' bounds of
    the reference's chain_vmap(jax.value_and_grad(potential)); the count
    goes up by C a call, and the loop of a potential without the batched
    entry is untouched."""
    x, y = _logreg()
    args, kw = (torch.from_numpy(x),), {"y": torch.from_numpy(y)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        pot = initialize_model_structure(None, logreg_model_glm, args, kw)[0]
    assert pot.glm_prior_batch == "vmap"
    counted = counting(pot)
    assert hasattr(counted, "value_and_grad_batch")
    z = (0.3 * np.random.default_rng(chains).standard_normal((chains, 4))) \
        .astype(np.float32)
    pe, g = hu.chain_value_and_grad(counted)(torch.from_numpy(z))
    assert counted.count == chains
    want_pe, want_g = _loop(pot, torch.from_numpy(z))
    assert torch.equal(pe, want_pe) and torch.equal(g, want_g)
    jpot = j_init_structure(jax.random.PRNGKey(0), j_logreg,
                            (jnp.asarray(x),), {"y": jnp.asarray(y)})[0]
    jpe, jg = jhu.chain_vmap(jax.value_and_grad(jpot))(jnp.asarray(z))
    np.testing.assert_allclose(pe.numpy(), np.asarray(jpe), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4)
    plain = counting(lambda zz: pot(zz))  # no batched entry: the loop
    pe2, g2 = hu.chain_value_and_grad(plain)(torch.from_numpy(z))
    assert plain.count == chains
    assert torch.equal(pe2, want_pe) and torch.equal(g2, want_g)


def test_ensemble_reports_vmapped_prior_and_counts_chains():
    """MALA on the CPU: one batched evaluation of all chains per
    iteration, C counted each; the searches per chain."""
    x, y = _logreg()
    chains, warmup, draws = 4, 3, 2
    mcmc = MCMC(MALA(logreg_model_glm, device="cpu"), num_warmup=warmup,
                num_samples=draws, num_chains=chains)
    mcmc.run(0, torch.from_numpy(x), y=torch.from_numpy(y))
    stats = mcmc.stats
    assert stats["glm_prior"] == "slim"
    assert stats["glm_prior_batch"] == "vmap"
    assert stats["num_grad_evals"] == \
        chains * (warmup + draws) + stats["init_grad_evals"]


def _branching_prior(x, y=None):
    """A prior that branches on a latent's value: vmap cannot trace it."""
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d))
                  .to_event(1))
    if bool(torch.all(torch.isfinite(w))):
        pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
                  infer={"potential": "glm"})


def test_prior_vmap_cannot_trace_runs_as_loop():
    x, y = _logreg(seed=4)
    args, kw = (torch.from_numpy(x),), {"y": torch.from_numpy(y)}
    with pytest.warns(UserWarning, match="cannot trace its prior"):
        pot = initialize_model_structure(None, _branching_prior, args, kw)[0]
    assert pot.glm_prior_batch == "loop"
    z = torch.from_numpy((0.3 * np.random.default_rng(1)
                          .standard_normal((3, 4))).astype(np.float32))
    counted = counting(pot)
    pe, g = hu.chain_value_and_grad(counted)(z)
    assert counted.count == 3
    want_pe, want_g = _loop(pot, z)
    assert torch.equal(pe, want_pe) and torch.equal(g, want_g)
