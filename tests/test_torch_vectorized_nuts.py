"""Lockstep NUTS and HMC over C chains (``chain_method="vectorized"``)
against the sequential chains and against the JAX package's ``vmap``.

- Level 1: ``nuts_leaf_batch_ref``, ``nuts_turning_batch_ref`` and
  ``halfstep_chains_ref`` row c against the one-chain plain versions on
  chain c, with inactive chains and both directions.
- Bit for bit: on the CPU in float64 a vectorized run is the sequential run,
  chain for chain (draws, diagnostics, the generators' states after it), for
  NUTS and HMC on a model without the fused potential, and for NUTS on
  logreg's fused GLM potential.
- Level 2: lockstep NUTS transitions started from the reference's vmapped
  state with each chain's draws replayed from its key, as
  ``tests/test_torch_nuts.py`` does for one chain.
- Level 3: ``tests/test_mcmc.py:105``'s posterior, and
  ``tests/test_ensemble.py:186``'s cross-chain adaptation with its pooled
  estimate against the reference's ``welford_pool`` + ``welford_covariance``.
- The functional entry points, ``SamplerKernel`` and the exports.

Inputs are made with numpy or a seeded generator, so every test is
deterministic.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.models import logreg_model as j_logreg
from repro.core.infer import hmc_util as jhu
from repro.core.infer.hmc import nuts_setup as j_nuts_setup
from repro_torch import core as pc
from repro_torch.bench.models import logreg_model_glm
from repro_torch.core import dist
from repro_torch.core.infer import (HMC, MALA, MCMC, NUTS, RWM, ChEES,
                                    GeneratorDraws, SamplerKernel,
                                    gelman_rubin, hmc_init, hmc_setup,
                                    nuts_init, nuts_setup)
from repro_torch.core.infer import hmc_util as hu
from repro_torch.core.infer.hmc import HMCState
from repro_torch.interop import state_from_reference
from repro_torch.kernels import leapfrog as lf


class ReplayDraws:
    """One chain's reference draws, split from its key as
    ``repro.core.infer.hmc`` and ``hmc_util`` split it (the vmapped
    transition splits each chain's key the same way)."""

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


def chain_state(state, c):
    """Chain ``c`` of a batched state as a one-chain state (host scalars as
    Python or numpy float32 scalars, tensors as row views)."""
    if isinstance(state, tuple):
        return type(state)(*(chain_state(v, c) for v in state))
    if isinstance(state, np.ndarray):
        item = state[c].item()
        return np.float32(item) if state.dtype == np.float32 else item
    return state[c]


def _sources(seed, chains):
    seeds = np.random.SeedSequence(seed).generate_state(chains,
                                                        dtype=np.uint64)
    return [GeneratorDraws(torch.Generator().manual_seed(int(s)))
            for s in seeds]


def _funnel_data():
    return torch.tensor([0.3, -1.2, 2.1, 0.7], dtype=torch.float64)


def _hier(y):
    """A small hierarchical model without the fused potential."""
    mu = pc.sample("mu", dist.Normal(torch.tensor(0.0, dtype=torch.float64),
                                     torch.tensor(2.0, dtype=torch.float64)))
    tau = pc.sample("tau", dist.HalfNormal(torch.tensor(1.0,
                                                        dtype=torch.float64)))
    with pc.plate("J", y.shape[0]):
        pc.sample("y", dist.Normal(mu, tau + 0.5), obs=y)


def _logreg_data(n=300, d=4, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.7 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return x, y


# ---------------------------------------------------------------------------
# level 1: the chain-batched plain versions row by row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leaf", [(False, 0, None), (True, 3, None),
                                  (True, None, (4, 4)), (True, None, (1, 6))])
def test_batch_plain_versions_are_the_one_chain_ones_row_by_row(leaf):
    has_sum, ckpt_i, rows = leaf
    gen = torch.Generator().manual_seed(11)
    c, d = 5, 7

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    r_half, z, g, r_sum = (rand(c, d) for _ in range(4))
    m = torch.rand(c, d, generator=gen, dtype=torch.float64) + 0.5
    ck, sck, pe = rand(c, 8, d), rand(c, 8, d), rand(c)
    eps = torch.tensor([0.1, -0.1, 0.05, -0.2, 0.3], dtype=torch.float64)
    active = torch.tensor([True, False, True, True, False])
    idx = rows or (0, -1)
    ck_b, sck_b = ck.clone(), sck.clone()
    got = lf.nuts_leaf_batch_ref(r_half, z, g, pe, m, eps, active,
                                 r_sum if has_sum else None, ck_b, sck_b,
                                 ckpt_i, *idx)
    for i in range(c):
        if active[i]:
            ck_1, sck_1 = ck[i].clone(), sck[i].clone()
            want = lf.nuts_leaf_ref(r_half[i], z[i], g[i], pe[i], m[i],
                                    eps[i], r_sum[i] if has_sum else None,
                                    ck_1, sck_1, ckpt_i, *idx)
            for a, b in zip(got, want):
                assert torch.equal(a[i], b)
            assert torch.equal(ck_b[i], ck_1) and torch.equal(sck_b[i], sck_1)
        else:  # copied through
            kept = r_sum[i] if has_sum else r_half[i]
            for a, b in zip(got, (r_half[i], kept, None, z[i], r_half[i])):
                if b is not None:
                    assert torch.equal(a[i], b)
            assert not got[2][i].any()
            assert torch.equal(ck_b[i], ck[i])
    dots = lf.nuts_turning_batch_ref(m, r_half, g, r_sum)
    z2, r2 = lf.halfstep_chains_ref(z, r_half, g, m, eps, active)
    for i in range(c):
        assert torch.equal(dots[i], lf.nuts_turning_ref(m[i], r_half[i], g[i],
                                                        r_sum[i]))
        want = lf.leapfrog_halfstep_ref(z[i], r_half[i], g[i], m[i], eps[i]) \
            if active[i] else (z[i], r_half[i])
        assert torch.equal(z2[i], want[0]) and torch.equal(r2[i], want[1])


# ---------------------------------------------------------------------------
# vectorized == sequential, bit for bit
# ---------------------------------------------------------------------------

def _transitions(setup, seed, chains, num):
    """Positions and the generators' states of ``num`` transitions of each
    chain, run in lockstep and one after another."""
    draws = _sources(seed, chains)
    state = setup.init_batch_fn(draws)
    batched = [state.z]
    for _ in range(num):
        state = setup.sample_batch_fn(state, draws)
        batched.append(state.z)
    lone = []
    for one_draws in _sources(seed, chains):
        s = setup.init_fn(one_draws)
        zs = [s.z]
        for _ in range(num):
            s = setup.sample_fn(s, one_draws)
            zs.append(s.z)
        lone.append((torch.stack(zs), s, one_draws))
    return torch.stack(batched, 1), state, draws, lone


@pytest.mark.parametrize("algo", ["NUTS", "HMC"])
def test_vectorized_is_sequential_bit_for_bit_generic_potential(algo):
    y = _funnel_data()
    kwargs = {} if algo == "NUTS" else {"trajectory_length": 1.0}
    out = {}
    for method in ("vectorized", "sequential"):
        kernel = NUTS if algo == "NUTS" else HMC
        m = MCMC(kernel(_hier, device="cpu", **kwargs), num_warmup=30,
                 num_samples=30, num_chains=3, chain_method=method)
        m.run(0, y)
        out[method] = m
    vec, seq = out["vectorized"], out["sequential"]
    for get in ("get_samples", "get_extra_fields"):
        a, b = (getattr(m, get)(group_by_chain=True) for m in (vec, seq))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for k in ("num_leapfrog", "num_grad_evals", "init_grad_evals"):
        assert vec.stats[k] == seq.stats[k]
    leaves = vec.stats["lockstep_leapfrogs"]
    assert 0 < leaves <= vec.stats["num_leapfrog"]
    assert vec.stats["lockstep_efficiency"] == pytest.approx(
        vec.stats["num_leapfrog"] / (3 * leaves))
    assert seq.stats["lockstep_leapfrogs"] is None
    # the batched state against each lone chain's, and the generators
    setup = nuts_setup(None, 10, model=_hier, model_args=(y,),
                       device="cpu") if algo == "NUTS" else \
        hmc_setup(None, 10, model=_hier, model_args=(y,), device="cpu",
                  trajectory_length=1.0)
    zs, state, draws, lone = _transitions(setup, 4, 3, 12)
    for c, (zs_c, s_c, d_c) in enumerate(lone):
        assert torch.equal(zs[c], zs_c)
        assert torch.equal(draws[c].generator.get_state(),
                           d_c.generator.get_state())
        row = chain_state(state, c)
        assert torch.equal(row.adapt_state.step_size,
                           s_c.adapt_state.step_size)
        assert row.adapt_state.da_state == s_c.adapt_state.da_state
        assert (row.energy, row.num_steps, row.accept_prob) == \
            (s_c.energy, s_c.num_steps, s_c.accept_prob)


def test_vectorized_is_sequential_on_the_fused_glm_potential():
    """The fused potential's batched entry (one GLM call for the live
    chains) and the one-chain entry sum the same terms in the same order
    on the CPU, so the lockstep run is the sequential one bit for bit (the
    bound is 0)."""
    x, y = _logreg_data()
    out = {}
    for method in ("vectorized", "sequential"):
        m = MCMC(NUTS(logreg_model_glm, device="cpu"), num_warmup=25,
                 num_samples=25, num_chains=3, chain_method=method)
        m.run(0, x, y=y)
        out[method] = m.get_samples(group_by_chain=True)["w"]
        assert m.stats["glm_prior"] == "slim"
    assert torch.equal(out["vectorized"], out["sequential"])


# ---------------------------------------------------------------------------
# level 2: the reference's vmapped transition, replayed
# ---------------------------------------------------------------------------

def test_lockstep_transitions_replay_reference_vmap():
    """Lockstep transitions started from the reference's vmapped state,
    each chain replaying its own key's draws: positions, tree sizes, accept
    probabilities, divergences and adapted step sizes agree chain by
    chain."""
    x, y = _logreg_data(300, 4, 2)
    chains = 3
    setup = j_nuts_setup(jax.random.PRNGKey(0), 20, model=j_logreg,
                         model_args=(jnp.asarray(x),),
                         model_kwargs={"y": jnp.asarray(y)})
    port = nuts_setup(None, 20, model=logreg_model_glm,
                      model_args=(torch.from_numpy(x),),
                      model_kwargs={"y": torch.from_numpy(y)}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    state = jax.vmap(setup.init_fn)(keys)
    sample_fn = jax.jit(jax.vmap(setup.sample_fn))
    steps = []
    for _ in range(6):
        ref = jax.device_get(state)
        nxt = jax.device_get(sample_fn(state))
        ours = port.sample_batch_fn(
            state_from_reference(ref, "cpu"),
            [ReplayDraws(ref.rng_key[c]) for c in range(chains)])
        np.testing.assert_allclose(ours.z.numpy(), nxt.z, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(ours.num_steps, nxt.num_steps)
        np.testing.assert_array_equal(ours.diverging, nxt.diverging)
        np.testing.assert_allclose(ours.accept_prob, nxt.accept_prob,
                                   atol=1e-4)
        np.testing.assert_allclose(ours.adapt_state.step_size.numpy(),
                                   nxt.adapt_state.step_size, rtol=1e-4)
        steps.append(ours.num_steps.copy())
        state = sample_fn(state)
    steps = np.stack(steps)
    assert steps.max() > 1 and len(set(steps.ravel().tolist())) > 1


# ---------------------------------------------------------------------------
# level 3
# ---------------------------------------------------------------------------

def test_vectorized_chains_posterior():
    """tests/test_mcmc.py:105's model and bounds, both chain methods."""
    def model():
        pc.sample("x", dist.Normal(1.0, 2.0))

    for method in ("vectorized", "sequential"):
        m = MCMC(NUTS(model, device="cpu"), num_warmup=200, num_samples=300,
                 num_chains=2, chain_method=method)
        m.run(3)
        x = m.get_samples()["x"]
        assert abs(float(x.mean()) - 1.0) < 0.3
        assert abs(float(x.std()) - 2.0) < 0.4


def test_cross_chain_adapt_matches_posterior_and_pools_like_reference():
    """tests/test_ensemble.py:186 on the port; then the pooled estimate of
    one window's per-chain accumulators equals the reference's
    ``welford_pool`` + ``welford_covariance`` on the same draws."""
    sigma0, sigma = 2.0, 1.0
    y = torch.as_tensor(np.random.default_rng(0).normal(1.8, sigma, size=50))

    def model(y):
        mu = pc.sample("mu", dist.Normal(0.0, sigma0))
        with pc.plate("N", y.shape[0]):
            pc.sample("obs", dist.Normal(mu, sigma), obs=y)

    post_var = 1.0 / (1 / sigma0 ** 2 + len(y) / sigma ** 2)
    post_mean = post_var * (float(y.sum()) / sigma ** 2)
    mcmc = MCMC(NUTS(model, cross_chain_adapt=True, device="cpu"),
                num_warmup=300, num_samples=400, num_chains=4)
    mcmc.run(0, y)
    assert mcmc.kernel_setup.cross_chain
    mu = mcmc.get_samples()["mu"]
    assert abs(float(mu.mean()) - post_mean) < 0.1
    assert abs(float(mu.var()) - post_var) < 0.05
    grouped = mcmc.get_samples(group_by_chain=True)["mu"].numpy()
    assert float(gelman_rubin(grouped)) < 1.05
    imm = mcmc.last_state.adapt_state.inverse_mass_matrix.numpy()
    assert imm.shape[0] == 4 and np.all(imm == imm[0])
    with pytest.raises(ValueError, match="sequential"):
        MCMC(NUTS(model, cross_chain_adapt=True, device="cpu"), 5, 5,
             num_chains=2, chain_method="sequential").run(0, y)
    # the pooled estimate against the reference's
    rng = np.random.default_rng(5)
    for dense in (False, True):
        draws = rng.standard_normal((4, 7, 3))
        wfs = []
        for c in range(4):
            wf = hu.welford_init(3, torch.float64, diagonal=not dense)
            for row in draws[c]:
                wf = hu.welford_update(wf, torch.from_numpy(row))
            wfs.append(wf)
        pooled = hu.welford_pool(hu.WelfordState(
            torch.stack([w.mean for w in wfs]),
            torch.stack([w.m2 for w in wfs]), np.array([w.n for w in wfs])))
        ours = hu.welford_covariance(pooled).numpy()
        with jax.enable_x64(True):
            jwf = jax.vmap(lambda xs: jax.lax.fori_loop(
                0, 7, lambda i, s: jhu.welford_update(s, xs[i]),
                jhu.welford_init(3, diagonal=not dense)))(jnp.asarray(draws))
            theirs = np.asarray(jhu.welford_covariance(jhu.welford_pool(jwf)))
        # float64 on both sides: within a few roundings
        np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# entry points and exports
# ---------------------------------------------------------------------------

def test_functional_entry_points_and_sampler_kernel_protocol():
    import repro_torch.core.infer as infer
    y = _funnel_data()
    for init in (hmc_init, nuts_init):
        state, setup = init(torch.Generator().manual_seed(0), 10, model=_hier,
                            model_args=(y,), device="cpu")
        assert isinstance(state, HMCState) and setup.algo in ("HMC", "NUTS")
        nxt = setup.sample_fn(state, GeneratorDraws(
            torch.Generator().manual_seed(1)))
        assert nxt.i == 1 and torch.isfinite(nxt.z).all()
    state, setup = nuts_init(torch.Generator().manual_seed(0), 10,
                             model=_hier, model_args=(y,), device="cpu",
                             cross_chain_adapt=True,
                             draws=_sources(0, 2))
    assert setup.cross_chain and state.z.shape[0] == 2
    kernels = (NUTS(_hier, device="cpu"), HMC(_hier, device="cpu"),
               ChEES(_hier, device="cpu"), MALA(_hier, device="cpu"),
               RWM(_hier, device="cpu"))
    assert all(isinstance(k, SamplerKernel) for k in kernels)
    state = kernels[0].init(torch.Generator().manual_seed(0), 10,
                            model_args=(y,))
    assert isinstance(state, HMCState) and state.i == 0
    ens = kernels[3].init(torch.Generator().manual_seed(0), 10,
                          model_args=(y,), num_chains=3)
    assert ens.z.shape == (3, 2)
    for name in ("hmc_init", "nuts_init", "SamplerKernel", "ChEESState",
                 "MRWState", "chees_init"):
        assert name in infer.__all__ and hasattr(infer, name)
