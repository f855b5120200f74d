"""The dense mass matrix of the port's HMC/NUTS against the JAX package's.

- Level 1: the dense ``kinetic_energy``, ``momentum_sample``, Welford update,
  covariance and pool against the reference's functions on the same numpy
  inputs, both in float64 (the reference under ``jax.enable_x64``).
- Level 2: dense NUTS transitions started from the reference's state (its
  inverse mass matrix replaced by a correlated one) with its draws replayed.
- Level 3: ``tests/test_mcmc.py:191``'s check, dense beats diagonal on a
  correlated Gaussian, at 300 + 300; a dense run launches no NUTS leaf op.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jpc
from repro.core import dist as jdist
from repro.core.infer import hmc_util as jhu
from repro.core.infer.hmc import nuts_setup as j_nuts_setup
from repro_torch import core as pc
from repro_torch.core import dist
from repro_torch.core.infer import (MCMC, NUTS, effective_sample_size,
                                    nuts_setup)
from repro_torch.core.infer import hmc_util as hu
from repro_torch.interop import state_from_reference
from repro_torch.kernels import ops

# float64 on both sides: the same operations up to the order of a
# product's sums (matmul, Cholesky, triangular solve)
TOL = dict(rtol=1e-12, atol=1e-13)


def _spd(d, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    return a @ a.T / d + 0.5 * np.eye(d)


def test_dense_integrator_pieces_match_reference():
    rng = np.random.default_rng(0)
    d = 5
    imm = _spd(d, 1)
    r = rng.standard_normal(d)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(4)
        noise = np.array(jax.random.normal(key, (d,), jnp.float64))
        j_r = np.asarray(jhu.momentum_sample(key, jnp.asarray(imm),
                                             jnp.float64))
        j_ke = float(jhu.kinetic_energy(jnp.asarray(imm), jnp.asarray(r)))
        j_v = np.asarray(jhu.velocity(jnp.asarray(imm), jnp.asarray(r)))
    t_imm = torch.from_numpy(imm)
    np.testing.assert_allclose(
        hu.momentum_sample(torch.from_numpy(noise), t_imm).numpy(), j_r,
        **TOL)
    np.testing.assert_allclose(
        float(hu.kinetic_energy(t_imm, torch.from_numpy(r))), j_ke, **TOL)
    np.testing.assert_allclose(
        hu.velocity(t_imm, torch.from_numpy(r)).numpy(), j_v, **TOL)
    # a diagonal mass keeps the elementwise forms
    diag = torch.from_numpy(np.diag(imm).copy())
    assert torch.equal(hu.velocity(diag, torch.from_numpy(r)),
                       diag * torch.from_numpy(r))


@pytest.mark.parametrize("dense", [True, False])
def test_welford_update_covariance_and_pool_match_reference(dense):
    rng = np.random.default_rng(2)
    draws = rng.standard_normal((3, 9, 4)) @ np.linalg.cholesky(_spd(4, 3)).T
    wfs = []
    for chain in draws:
        wf = hu.welford_init(4, torch.float64, diagonal=not dense)
        for row in chain:
            wf = hu.welford_update(wf, torch.from_numpy(row))
        wfs.append(wf)
    with jax.enable_x64(True):
        jwfs = []
        for chain in draws:
            jwf = jhu.welford_init(4, diagonal=not dense)
            for row in chain:
                jwf = jhu.welford_update(jwf, jnp.asarray(row))
            jwfs.append(jwf)
        j_cov = [np.asarray(jhu.welford_covariance(w)) for w in jwfs]
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jwfs)
        j_pool = jhu.welford_pool(stacked)
        j_pool_cov = np.asarray(jhu.welford_covariance(j_pool))
    for ours, theirs, cov in zip(wfs, jwfs, j_cov):
        assert ours.n == int(theirs.n)
        np.testing.assert_allclose(ours.mean.numpy(), theirs.mean, **TOL)
        np.testing.assert_allclose(ours.m2.numpy(), theirs.m2, **TOL)
        np.testing.assert_allclose(hu.welford_covariance(ours).numpy(), cov,
                                   **TOL)
    pooled = hu.welford_pool(hu.WelfordState(
        torch.stack([w.mean for w in wfs]), torch.stack([w.m2 for w in wfs]),
        np.array([w.n for w in wfs])))
    assert pooled.n == int(j_pool.n)
    np.testing.assert_allclose(pooled.m2.numpy(), j_pool.m2, **TOL)
    np.testing.assert_allclose(hu.welford_covariance(pooled).numpy(),
                               j_pool_cov, **TOL)
    # the batched update (rows sharing n) is each row's update
    batch = hu.welford_init(4, torch.float64, diagonal=not dense)
    batch = hu.WelfordState(batch.mean.expand(3, 4).clone(),
                            batch.m2.expand((3,) + batch.m2.shape).clone(), 0)
    for k in range(9):
        batch = hu.welford_update(batch, torch.from_numpy(draws[:, k]))
    for c in range(3):
        assert torch.equal(batch.m2[c], wfs[c].m2)


class ReplayDraws:
    """The reference's draws of one chain, split from its key as
    ``repro.core.infer.hmc`` and ``hmc_util`` split it (the dense momentum
    is the same standard normal, scaled by the mass outside)."""

    def __init__(self, key):
        self.key = key

    def momentum(self, d, dtype):
        (self.key, key_mom, self.tree_key,
         self.accept_key) = jax.random.split(self.key, 4)
        return torch.from_numpy(np.array(
            jax.random.normal(key_mom, (d,), jnp.float32))).to(dtype)

    def direction(self):
        (self.tree_key, dir_key, subtree_key,
         self.transition_key) = jax.random.split(self.tree_key, 4)
        self.leaf_key = jax.random.split(subtree_key)[1]
        return bool(jax.random.bernoulli(dir_key))

    def leaf_uniform(self):
        self.leaf_key, key = jax.random.split(self.leaf_key)
        return float(jax.random.uniform(key))

    def merge_uniform(self):
        return float(jax.random.uniform(self.transition_key))


RHO = 0.95


def _mvn(P, D, A):
    cov = A([[1.0, RHO], [RHO, 1.0]])
    P.sample("x", D.MultivariateNormal(A([0.0, 0.0]), covariance_matrix=cov))


def test_dense_nuts_transitions_replay_reference():
    """Dense NUTS transitions from the reference's state with a correlated
    inverse mass matrix and replayed draws: positions, tree sizes,
    divergences and accept probabilities agree."""
    setup = j_nuts_setup(jax.random.PRNGKey(0), 20,
                         model=lambda: _mvn(jpc, jdist, jnp.asarray),
                         dense_mass=True)
    port = nuts_setup(None, 20, model=lambda: _mvn(
        pc, dist, lambda v: torch.tensor(v, dtype=torch.float32)),
        dense_mass=True, device="cpu")
    imm = jnp.asarray([[1.0, 0.9], [0.9, 1.2]], jnp.float32)
    state = setup.init_fn(jax.random.PRNGKey(3))
    state = state._replace(adapt_state=state.adapt_state._replace(
        inverse_mass_matrix=imm))
    sample_fn = jax.jit(setup.sample_fn)
    steps = []
    ops.reset_launch_counts()
    for _ in range(8):
        ref = jax.device_get(state)
        nxt = jax.device_get(sample_fn(state))
        ours = port.sample_fn(state_from_reference(ref, "cpu"),
                              ReplayDraws(ref.rng_key))
        np.testing.assert_allclose(ours.z.numpy(), nxt.z, rtol=1e-4,
                                   atol=1e-5)
        assert ours.num_steps == int(nxt.num_steps)
        assert bool(ours.diverging) == bool(nxt.diverging)
        np.testing.assert_allclose(float(ours.accept_prob),
                                   float(nxt.accept_prob), atol=1e-4)
        assert ours.adapt_state.inverse_mass_matrix.shape == (2, 2)
        steps.append(ours.num_steps)
        state = sample_fn(state)
    assert max(steps) > 1
    counts = ops.launch_counts()
    assert counts["nuts_leaf"] == counts["nuts_turning"] == 0


def test_dense_mass_beats_diagonal_on_correlated_gaussian():
    """tests/test_mcmc.py:191's check at 300 + 300."""
    def model():
        _mvn(pc, dist, lambda v: torch.tensor(v, dtype=torch.float32))

    ess = {}
    for dense in (False, True):
        mcmc = MCMC(NUTS(model, dense_mass=dense, device="cpu"),
                    num_warmup=300, num_samples=300)
        mcmc.run(0)
        x = mcmc.get_samples(group_by_chain=True)["x"].numpy()
        ess[dense] = min(effective_sample_size(x[..., 0]),
                         effective_sample_size(x[..., 1]))
        assert abs(float(x.mean())) < 0.2
        imm = mcmc.last_state[0].adapt_state.inverse_mass_matrix
        assert imm.shape == ((2, 2) if dense else (2,))
    assert ess[True] > 1.5 * ess[False], ess
