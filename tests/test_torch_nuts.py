"""The port's NUTS against the JAX package's.

- Level 2: one ``velocity_verlet`` step, and NUTS transitions started from
  the reference's own state (``interop.state_from_reference``) with the
  reference's random draws replayed into the port (:class:`ReplayDraws`
  follows the reference's key splits).  ``z``, ``num_steps``,
  ``accept_prob``, the divergence flag and the adapted step size agree.
- Level 3: whole runs on a small logistic regression agree in posterior
  mean within 4 Monte Carlo standard errors, with split R-hat < 1.05.

Inputs are made with numpy from fixed seeds, so every test is deterministic.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.models import logreg_model as j_logreg
from repro.core.infer import MCMC as JMCMC
from repro.core.infer import NUTS as JNUTS
from repro.core.infer import initialize_model_structure as j_init_structure
from repro.core.infer.hmc import nuts_setup as j_nuts_setup
from repro.core.infer.hmc_util import IntegratorState as JIntegratorState
from repro.core.infer.hmc_util import velocity_verlet as j_velocity_verlet
from repro_torch.bench.models import logreg_model, logreg_model_glm
from repro_torch.core.errors import NO_DEVICE, ReproError
from repro_torch.core.infer import (HMC, MCMC, NUTS, effective_sample_size,
                                    gelman_rubin, initialize_model_structure,
                                    nuts_setup)
from repro_torch.core.infer.hmc_util import IntegratorState, velocity_verlet
from repro_torch.interop import state_from_reference


class ReplayDraws:
    """The reference's draws, split from its chain key exactly as
    ``repro.core.infer.hmc`` and ``hmc_util`` split it."""

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

    def accept_uniform(self):
        return float(jax.random.uniform(self.accept_key))


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.7 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return x, y


def test_velocity_verlet_step_matches_reference():
    x, y = _data(400, 5, 0)
    pot = initialize_model_structure(None, logreg_model, (torch.from_numpy(x),),
                                     {"y": torch.from_numpy(y)})[0]
    jpot = j_init_structure(jax.random.PRNGKey(0), j_logreg, (jnp.asarray(x),),
                            {"y": jnp.asarray(y)})[0]
    rng = np.random.default_rng(1)
    z, r = (0.3 * rng.standard_normal((2, 5))).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    init, update = velocity_verlet(pot)
    jinit, jupdate = j_velocity_verlet(jpot)
    pe, g = init(torch.from_numpy(z))
    jpe, jg = jinit(jnp.asarray(z))
    out = update(torch.tensor(0.05), torch.from_numpy(imm),
                 IntegratorState(torch.from_numpy(z), torch.from_numpy(r),
                                 pe, g))
    jout = jupdate(jnp.float32(0.05), jnp.asarray(imm),
                   JIntegratorState(jnp.asarray(z), jnp.asarray(r), jpe, jg))
    for a, b, tol in ((out.z, jout.z, 1e-6), (out.r, jout.r, 1e-4),
                      (out.potential_energy, jout.potential_energy, 1e-3),
                      (out.z_grad, jout.z_grad, 1e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=tol)


@pytest.mark.parametrize("model", [logreg_model, logreg_model_glm])
def test_nuts_transitions_replay_reference(model):
    """Each transition starts from the reference's state and replays its
    draws; warmup transitions also compare the adapted step size."""
    x, y = _data(300, 4, 2)
    setup = j_nuts_setup(jax.random.PRNGKey(0), 20, model=j_logreg,
                         model_args=(jnp.asarray(x),),
                         model_kwargs={"y": jnp.asarray(y)})
    port = nuts_setup(None, 20, model=model, model_args=(torch.from_numpy(x),),
                      model_kwargs={"y": torch.from_numpy(y)}, device="cpu")
    state = setup.init_fn(jax.random.PRNGKey(3))
    sample_fn = jax.jit(setup.sample_fn)
    steps = []
    for _ in range(8):
        ref = jax.device_get(state)
        nxt = jax.device_get(sample_fn(state))
        ours = port.sample_fn(state_from_reference(ref, "cpu"),
                              ReplayDraws(ref.rng_key))
        np.testing.assert_allclose(ours.z.numpy(), nxt.z, rtol=1e-5, atol=1e-5)
        assert ours.num_steps == int(nxt.num_steps)
        assert bool(ours.diverging) == bool(nxt.diverging)
        np.testing.assert_allclose(float(ours.accept_prob),
                                   float(nxt.accept_prob), atol=1e-4)
        np.testing.assert_allclose(float(ours.adapt_state.step_size),
                                   float(nxt.adapt_state.step_size),
                                   rtol=1e-4)
        steps.append(ours.num_steps)
        state = sample_fn(state)
    assert max(steps) > 1  # the replay went through real trees


def _posterior(mcmc_samples):
    w = np.asarray(mcmc_samples)  # (chains, draws, d)
    return w.mean((0, 1)), w.std((0, 1)), effective_sample_size(w)


def test_nuts_posterior_matches_reference_run():
    x, y = _data(500, 3, 4)
    m = MCMC(NUTS(logreg_model_glm, device="cpu"), num_warmup=300,
             num_samples=300, num_chains=2, chain_method="sequential",
             device="cpu")
    m.run(0, x, y=y)
    w = m.get_samples(group_by_chain=True)["w"].numpy()
    jm = JMCMC(JNUTS(j_logreg), num_warmup=300, num_samples=300, num_chains=2)
    jm.run(jax.random.PRNGKey(0), jnp.asarray(x), y=jnp.asarray(y))
    jw = np.asarray(jm.get_samples(group_by_chain=True)["w"])
    mean, sd, ess = _posterior(w)
    jmean, jsd, jess = _posterior(jw)
    se = np.sqrt(sd ** 2 / ess + jsd ** 2 / jess)
    assert np.all(np.abs(mean - jmean) <= 4 * se), (mean, jmean, se)
    assert np.all(gelman_rubin(w) < 1.05)
    assert int(m.get_extra_fields()["diverging"].sum()) == 0
    assert m.stats["num_leapfrog"] > 0 and m.stats["host_syncs"] > 0
    assert m.stats["glm_prior"] == "slim"


def test_same_seed_same_samples_other_seed_other_samples():
    x, y = _data(200, 2, 5)

    def run(seed):
        m = MCMC(NUTS(logreg_model_glm, device="cpu"), num_warmup=30,
                 num_samples=20)
        return m.run(seed, x, y=y).get_samples()["w"]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_hmc_runs_and_moves():
    x, y = _data(200, 2, 6)
    m = MCMC(HMC(logreg_model, trajectory_length=0.5, device="cpu"),
             num_warmup=50, num_samples=50)
    w = m.run(0, x, y=y).get_samples()["w"]
    assert w.shape == (50, 2) and torch.isfinite(w).all()
    assert float(w.std(0).min()) > 0


def test_vectorized_chains_wait_for_batched_nuts():
    """Lockstep NUTS has landed: ``chain_method="vectorized"`` (the
    default) with several chains runs on ``device="cpu"``; so has
    ``"parallel"``, which on one rank (a group it starts in this process)
    gives the same draws."""
    x, y = _data(60, 2, 7)
    m = MCMC(NUTS(logreg_model, device="cpu"), num_warmup=5, num_samples=5,
             num_chains=2)
    w = m.run(0, x, y=y).get_samples(group_by_chain=True)["w"]
    assert m.chain_method == "vectorized" and w.shape == (2, 5, 2)
    assert torch.isfinite(w).all() and m.stats["lockstep_leapfrogs"] > 0
    import torch.distributed as tdist
    started = not tdist.is_initialized()
    try:
        p = MCMC(NUTS(logreg_model, device="cpu"), num_warmup=5,
                 num_samples=5, num_chains=2, chain_method="parallel")
        assert torch.equal(p.run(0, x, y=y).get_samples(
            group_by_chain=True)["w"], w)
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert NUTS(logreg_model).device.type == "cuda"
        assert MCMC(NUTS(logreg_model), 1, 1).device.type == "cuda"
    else:
        with pytest.raises(ReproError, match=NO_DEVICE):
            NUTS(logreg_model)
        with pytest.raises(ReproError, match=NO_DEVICE):
            MCMC(NUTS(logreg_model, device="cpu"), 1, 1, device="cuda")
        with pytest.raises(ReproError, match=NO_DEVICE):
            nuts_setup(None, 1, model=logreg_model,
                       model_args=(torch.zeros(4, 2),))


def test_setup_rejects_arguments_on_another_device():
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        nuts_setup(None, 1, model=logreg_model, model_args=(x,),
                   device="cpu")
