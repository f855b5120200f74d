"""The port's SKIM (``repro_torch.bench.models.skim_model``) against the JAX
package's ``benchmarks/models.py:skim_model``, on the port's numpy data:

- level 1: the flat potential and its gradient against
  ``jax.value_and_grad`` of the reference's at the same unconstrained
  points (p = 16, n = 40): within 1e-12 of the largest magnitude in
  float64 (the reference under ``jax.enable_x64``), 1e-5 in float32;
- level 2: NUTS transitions started from the reference's state with its
  draws replayed (``ReplayDraws``): the same tree sizes and divergences,
  ``z``, ``accept_prob`` and the adapted step size within 1e-4;
- level 3 at p = 32, n = 100: posterior means of each site's log within 4
  Monte Carlo standard errors of the reference's, and the planted-dimension
  gate of ``chip_smoke.py`` (the ``2 * n_inter`` largest posterior-median
  ``lambda`` are the planted dimensions) holding for both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.models import skim_model as j_skim_model
from chip_smoke import skim_planted_gate
from repro.core.infer import MCMC as JMCMC
from repro.core.infer import NUTS as JNUTS
from repro.core.infer import initialize_model_structure as j_init_structure
from repro.core.infer.hmc import nuts_setup as j_nuts_setup
from repro_torch.bench.models import skim_data, skim_model
from repro_torch.core.infer import (MCMC, NUTS, effective_sample_size,
                                    initialize_model_structure, nuts_setup)
from repro_torch.interop import state_from_reference
from test_torch_nuts import ReplayDraws


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors are small: intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_skim_data_plants_disjoint_pairs():
    d = skim_data(64, seed=3, n=50, n_inter=4)
    assert d["x"].shape == (50, 64) and d["y"].shape == (50,)
    assert d["x"].dtype == d["y"].dtype == np.float32
    pairs = d["true_pairs"]
    assert pairs.shape == (4, 2) and len(np.unique(pairs)) == 8
    again = skim_data(64, seed=3, n=50, n_inter=4)
    assert np.array_equal(d["y"], again["y"])
    main = d["x"] @ np.isin(np.arange(64), pairs[:, 0])
    inter = sum(d["x"][:, a] * d["x"][:, b] for a, b in pairs)
    assert np.abs(d["y"] - main - 2.0 * inter).std() < 0.2


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-5)])
def test_potential_and_gradient_match_reference(dtype, rtol):
    d = skim_data(16, seed=1, n=40)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    with jax.enable_x64(dtype == "float64"):
        pot = initialize_model_structure(
            None, skim_model, (torch.from_numpy(d["x"]).to(tdt),),
            {"y": torch.from_numpy(d["y"]).to(tdt)})[0]
        jpot = j_init_structure(
            jax.random.PRNGKey(0), j_skim_model, (jnp.asarray(d["x"], jdt),),
            {"y": jnp.asarray(d["y"], jdt)})[0]
        jvalue_and_grad = jax.jit(jax.value_and_grad(jpot))
        rng = np.random.default_rng(0)
        for _ in range(4):
            z = rng.uniform(-2, 2, 16 + 4)
            zt = torch.tensor(z, dtype=tdt, requires_grad=True)
            value = pot(zt)
            grad, = torch.autograd.grad(value, zt)
            jvalue, jgrad = jvalue_and_grad(jnp.asarray(z, jdt))
            assert abs(value.item() - float(jvalue)) \
                <= rtol * abs(float(jvalue))
            jgrad = np.asarray(jgrad)
            assert np.max(np.abs(grad.numpy() - jgrad)) \
                <= rtol * np.max(np.abs(jgrad))


def test_nuts_transitions_replay_reference():
    d = skim_data(16, seed=1, n=40)
    setup = j_nuts_setup(jax.random.PRNGKey(0), 20, model=j_skim_model,
                         model_args=(jnp.asarray(d["x"]),),
                         model_kwargs={"y": jnp.asarray(d["y"])},
                         max_tree_depth=8)
    port = nuts_setup(None, 20, model=skim_model,
                      model_args=(torch.from_numpy(d["x"]),),
                      model_kwargs={"y": torch.from_numpy(d["y"])},
                      max_tree_depth=8, device="cpu")
    state = setup.init_fn(jax.random.PRNGKey(3))
    sample_fn = jax.jit(setup.sample_fn)
    steps = []
    for _ in range(6):
        ref = jax.device_get(state)
        nxt = jax.device_get(sample_fn(state))
        ours = port.sample_fn(state_from_reference(ref, "cpu"),
                              ReplayDraws(ref.rng_key))
        assert ours.num_steps == int(nxt.num_steps)
        assert bool(ours.diverging) == bool(nxt.diverging)
        np.testing.assert_allclose(ours.z.numpy(), nxt.z, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(ours.accept_prob),
                                   float(nxt.accept_prob), atol=1e-4)
        np.testing.assert_allclose(float(ours.adapt_state.step_size),
                                   float(nxt.adapt_state.step_size),
                                   rtol=1e-4)
        steps.append(ours.num_steps)
        state = sample_fn(state)
    assert max(steps) >= 127  # the replay went through deep trees


def test_posterior_matches_reference_and_finds_the_planted_pairs():
    d = skim_data(32, seed=0, n=100)
    m = MCMC(NUTS(skim_model, max_tree_depth=8, device="cpu"),
             num_warmup=60, num_samples=100)
    m.run(0, d["x"], y=d["y"])
    jm = JMCMC(JNUTS(j_skim_model, max_tree_depth=8), num_warmup=200,
               num_samples=200)
    jm.run(jax.random.PRNGKey(0), jnp.asarray(d["x"]), y=jnp.asarray(d["y"]))
    ours = {k: np.log(v.numpy())
            for k, v in m.get_samples(group_by_chain=True).items()}
    theirs = {k: np.log(np.asarray(v))
              for k, v in jm.get_samples(group_by_chain=True).items()}
    assert set(ours) == set(theirs) == {"lambda", "tau", "eta1", "c2",
                                        "sigma"}
    for name in ours:
        a, b = ours[name], theirs[name]
        se = np.sqrt(a.std((0, 1)) ** 2 / effective_sample_size(a)
                     + b.std((0, 1)) ** 2 / effective_sample_size(b))
        assert np.all(np.abs(a.mean((0, 1)) - b.mean((0, 1))) <= 4 * se), \
            name
    assert int(m.get_extra_fields()["diverging"].sum()) <= 1
    for lam in (np.exp(ours["lambda"]), np.exp(theirs["lambda"])):
        ok, top = skim_planted_gate(lam, d["true_pairs"])
        assert ok, (top, d["true_pairs"])
