"""The port's ensemble samplers (ChEES, MALA, RWM) against the JAX package's.

- Level 1, on shared numpy inputs: the pairwise ``chain_sum``/``chain_mean``
  fold and the pooled Welford accumulators (1e-6, float32), ``halton``
  (exact), ``adam_step`` (1e-7) and the chain-batched trajectory with merged
  kicks, ``velocity_verlet_batch``.
- Level 2: consecutive ChEES, MALA and RWM transitions, each started from
  the reference's ensemble state (``interop.state_from_reference``) with the
  reference's own draws (:class:`EnsembleReplay` splits its shared key as
  its ``sample_fn`` does), through a middle-window end and the last warmup
  step into sampling.  ``num_steps`` and ``diverging`` agree exactly, ``z``
  within ``Z_TOL`` and ``accept_prob`` and the adapted step size, log
  trajectory length and inverse mass within ``REPLAY_TOL``: the two packages sum the float32 potential in
  another order, and ``exp``/``pow`` on the host differ from XLA's by an
  ulp.  On ``logreg_model_glm`` (the fused GLM loop through its plain
  version) and on a conjugate normal.
- Level 3: a ChEES conjugate-normal posterior (mean and sd against the
  closed form, split R-hat < 1.01).
- The executor's contract for cross-chain kernels: lockstep trajectories,
  ``sequential`` raises, thinning keeps the extra fields aligned, one setup
  run twice from one seed is bit-identical.

The reference's ChEES and MALA call ``hmc_util.shared_draw``, which breaks
on jax 0.9.0 at ``repro/_compat.py``; the fixture below replaces
``repro._compat.ensure_optimization_barrier_batch_rule`` with a no-op in
this test process only (jax 0.9.0 batches ``optimization_barrier`` itself).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro._compat
import repro.core as jpc
from benchmarks.models import logreg_model as j_logreg
from repro.core import dist as jdist
from repro.core.infer import hmc_util as jhu
from repro.core.infer import initialize_model_structure as j_init_structure
from repro.core.infer.ensemble import AdamState as JAdamState
from repro.core.infer.ensemble import adam_step as j_adam_step
from repro.core.infer.ensemble import chees_setup as j_chees_setup
from repro.core.infer.ensemble import halton as j_halton
from repro.core.infer.mala import mrw_setup as j_mrw_setup
from repro_torch import core as pc
from repro_torch.bench.models import logreg_model_glm
from repro_torch.core import dist
from repro_torch.core.errors import NO_DEVICE, ReproError
from repro_torch.core.infer import (MALA, MCMC, RWM, ChEES, chees_setup,
                                    gelman_rubin, initialize_model_structure,
                                    mrw_setup)
from repro_torch.core.infer import hmc_util as hu
from repro_torch.core.infer.ensemble import AdamState, adam_step, halton
from repro_torch.interop import state_from_reference

# accept_prob and the adapted scalars (see the docstring; the largest
# errors seen are 3e-5 absolute and 4e-5 relative), and z (5e-7 seen)
REPLAY_TOL = dict(rtol=1e-4, atol=1e-4)
Z_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _reference_on_jax_0_9(monkeypatch):
    monkeypatch.setattr(repro._compat,
                        "ensure_optimization_barrier_batch_rule",
                        lambda: None)


class EnsembleReplay:
    """The reference's ensemble draws, split from its shared key exactly as
    ``ensemble.py``'s and ``mala.py``'s ``sample_fn`` split it: ``(key,
    key_mom or key_noise, key_acc) = split(key, 3)``, per-chain momenta from
    ``split(key_mom, C)``, per-chain uniforms from ``split(key_acc, C)``."""

    def __init__(self, key):
        _, self.key_draw, self.key_acc = jax.random.split(key, 3)

    def momentum_batch(self, c, d, dtype):
        keys = jax.random.split(self.key_draw, c)
        r = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys)
        return torch.from_numpy(np.array(r)).to(dtype)

    def noise(self, c, d, dtype):
        xi = jax.random.normal(self.key_draw, (c, d))
        return torch.from_numpy(np.array(xi)).to(dtype)

    def accept_uniforms(self, c, dtype):
        u = jax.vmap(jax.random.uniform)(jax.random.split(self.key_acc, c))
        return torch.from_numpy(np.array(u)).to(dtype)


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.7 * rng.standard_normal(d)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return x, y


# the conjugate normal: mu ~ N(0, 5^2 I), y_i ~ N(mu, I)
PRIOR_SD = 5.0


def j_normal_model(y):
    mu = jpc.sample("mu", jdist.Normal(jnp.zeros(y.shape[-1]),
                                       PRIOR_SD).to_event(1))
    with jpc.plate("n", y.shape[0]):
        jpc.sample("y", jdist.Normal(mu, 1.0).to_event(1), obs=y)


def normal_model(y):
    mu = pc.sample("mu", dist.Normal(y.new_zeros(y.shape[-1]),
                                     PRIOR_SD).to_event(1))
    with pc.plate("n", y.shape[0]):
        pc.sample("y", dist.Normal(mu, 1.0).to_event(1), obs=y)


def _normal_data(n=40, d=2, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) + np.array([1.0, -2.0])[:d]) \
        .astype(np.float32)


def _normal_posterior(y):
    """Closed-form posterior mean and sd of ``mu`` per coordinate."""
    precision = 1.0 / PRIOR_SD ** 2 + y.shape[0]
    return y.sum(0) / precision, np.full(y.shape[1], precision ** -0.5)


# the two models, as (port model, reference model, port args, reference
# args, port kwargs, reference kwargs)
def _models():
    x, y = _data(300, 4, 2)
    yn = _normal_data()
    return {
        "logreg_glm": (logreg_model_glm, j_logreg, (torch.from_numpy(x),),
                       (jnp.asarray(x),), {"y": torch.from_numpy(y)},
                       {"y": jnp.asarray(y)}),
        "normal": (normal_model, j_normal_model, (torch.from_numpy(yn),),
                   (jnp.asarray(yn),), {}, {}),
    }


# ---------------------------------------------------------------------------
# level 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 2, 3, 5, 7, 8])
def test_chain_sum_and_mean_match_reference(c):
    x = np.random.default_rng(c).standard_normal((c, 6)).astype(np.float32)
    for ours, ref in ((hu.chain_sum, jhu.chain_sum),
                      (hu.chain_mean, jhu.chain_mean)):
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(x))),
                                   rtol=0, atol=1e-6)


def _welford_close(ours, ref):
    assert int(ours.n) == int(ref.n)
    for a, b in ((ours.mean, ref.mean), (ours.m2, ref.m2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_welford_batch_combine_pool_match_reference():
    rng = np.random.default_rng(2)
    draws = rng.standard_normal((3, 7, 4)).astype(np.float32)  # (C, n, D)
    for c in range(3):
        _welford_close(hu.welford_batch(torch.from_numpy(draws[c])),
                       jhu.welford_batch(jnp.asarray(draws[c])))
    # combine: empty + batch, then batch + batch
    empty, jempty = hu.welford_init(4), jhu.welford_init(4)
    a, ja = (hu.welford_batch(torch.from_numpy(draws[0])),
             jhu.welford_batch(jnp.asarray(draws[0])))
    b, jb = (hu.welford_batch(torch.from_numpy(draws[1])),
             jhu.welford_batch(jnp.asarray(draws[1])))
    _welford_close(hu.welford_combine(empty, a), jhu.welford_combine(jempty,
                                                                     ja))
    _welford_close(hu.welford_combine(a, b), jhu.welford_combine(ja, jb))
    # pool: the per-chain accumulators (leaves lead with C) into one
    per_chain = [hu.welford_batch(torch.from_numpy(d)) for d in draws]
    pooled = hu.welford_pool(hu.WelfordState(
        torch.stack([s.mean for s in per_chain]),
        torch.stack([s.m2 for s in per_chain]),
        torch.tensor([s.n for s in per_chain])))
    jpooled = jhu.welford_pool(jax.vmap(jhu.welford_batch)(
        jnp.asarray(draws)))
    _welford_close(pooled, jpooled)
    assert pooled.n == 21


def test_halton_matches_reference_exactly():
    for t in list(range(300)) + [65534, 65535, 65536, 123456]:
        assert halton(t) == np.float32(j_halton(jnp.int32(t))), t


def test_adam_step_matches_reference():
    grads = np.random.default_rng(4).standard_normal(40).astype(np.float32)
    ours = AdamState(np.float32(0), np.float32(0), 0)
    ref = JAdamState(jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32))
    for g in grads * np.float32(3.0):
        delta, ours = adam_step(ours, g, 0.05)
        jdelta, ref = j_adam_step(ref, jnp.float32(g), 0.05)
        assert abs(float(delta) - float(jdelta)) <= 1e-7
        assert abs(float(ours.m) - float(ref.m)) <= 1e-7
        assert abs(float(ours.v) - float(ref.v)) <= 1e-7
        assert ours.t == int(ref.t)


@pytest.mark.parametrize("num_steps", [1, 4])
def test_velocity_verlet_batch_matches_reference(num_steps):
    model, jmodel, args, jargs, kwargs, jkwargs = _models()["logreg_glm"]
    pot = initialize_model_structure(None, model, args, kwargs)[0]
    jpot = j_init_structure(jax.random.PRNGKey(0), jmodel, jargs, jkwargs)[0]
    rng = np.random.default_rng(5)
    z, r = (0.3 * rng.standard_normal((2, 3, 4))).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    pe, g = hu.chain_value_and_grad(pot)(torch.from_numpy(z))
    jpe, jg = jax.vmap(jax.value_and_grad(jpot))(jnp.asarray(z))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4)
    out = hu.velocity_verlet_batch(pot)(
        0.05, torch.from_numpy(imm),
        hu.IntegratorState(torch.from_numpy(z), torch.from_numpy(r), pe, g),
        num_steps)
    jout = jax.jit(jhu.velocity_verlet_batch(jpot), static_argnums=3)(
        jnp.float32(0.05), jnp.asarray(imm),
        jhu.IntegratorState(jnp.asarray(z), jnp.asarray(r), jpe, jg),
        num_steps)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **REPLAY_TOL)


# ---------------------------------------------------------------------------
# level 2
# ---------------------------------------------------------------------------

def _replay(port, jsetup, keys, transitions, compare):
    """Run the reference's transitions and replay each in the port from
    the reference's state before it; ``compare(ours, ref_next)``."""
    state = jsetup.init_fn(keys)
    sample_fn = jax.jit(jsetup.sample_fn)
    for _ in range(transitions):
        ref = jax.device_get(state)
        state = sample_fn(state)
        nxt = jax.device_get(state)
        ours = port.sample_fn(state_from_reference(ref, "cpu"),
                              EnsembleReplay(ref.rng_key))
        assert ours.i == int(nxt.i)
        np.testing.assert_allclose(ours.z.numpy(), nxt.z, **Z_TOL)
        np.testing.assert_allclose(ours.accept_prob.numpy(), nxt.accept_prob,
                                   **REPLAY_TOL)
        np.testing.assert_array_equal(ours.diverging.numpy(), nxt.diverging)
        np.testing.assert_allclose(ours.potential_energy.numpy(),
                                   nxt.potential_energy, rtol=1e-5, atol=1e-3)
        adapt, jadapt = ours.adapt_state, nxt.adapt_state
        np.testing.assert_allclose(float(adapt.step_size),
                                   float(jadapt.step_size), **REPLAY_TOL)
        np.testing.assert_allclose(adapt.inverse_mass_matrix.numpy(),
                                   jadapt.inverse_mass_matrix, **REPLAY_TOL)
        assert adapt.welford.n == int(jadapt.welford.n)
        compare(ours, nxt)


@pytest.mark.parametrize("name", ["logreg_glm", "normal"])
def test_chees_transitions_replay_reference(name):
    """24 transitions at num_warmup=20: the middle window [3, 17] ends (mass
    refresh, dual-averaging restart, Adam reset) at t = 17, the averaged
    step size is frozen at t = 19, then four sampling transitions."""
    model, jmodel, args, jargs, kwargs, jkwargs = _models()[name]
    jsetup = j_chees_setup(jax.random.PRNGKey(0), 20, model=jmodel,
                           model_args=jargs, model_kwargs=jkwargs)
    port = chees_setup(None, 20, model=model, model_args=args,
                       model_kwargs=kwargs, device="cpu")
    assert jsetup.adapt_schedule == port.adapt_schedule == \
        ((0, 2), (3, 17), (18, 19))
    steps = []

    def compare(ours, nxt):
        assert ours.num_steps == int(nxt.num_steps)
        np.testing.assert_allclose(float(ours.adapt_state.log_traj),
                                   float(nxt.adapt_state.log_traj),
                                   **REPLAY_TOL)
        assert ours.adapt_state.adam_state.t == int(nxt.adapt_state.adam_state.t)
        steps.append(ours.num_steps)

    _replay(port, jsetup, jax.random.split(jax.random.PRNGKey(3), 4), 24,
            compare)
    assert max(steps) > 1  # real trajectories, not single steps


@pytest.mark.parametrize("algo", ["MALA", "RWM"])
@pytest.mark.parametrize("name", ["logreg_glm", "normal"])
def test_mrw_transitions_replay_reference(algo, name):
    """24 transitions at num_warmup=20, through the window end at t = 17
    and the freeze at t = 19; MALA's gradients at the accepted points
    agree too, RWM keeps its initial ones."""
    model, jmodel, args, jargs, kwargs, jkwargs = _models()[name]
    jsetup = j_mrw_setup(jax.random.PRNGKey(0), 20, algo, model=jmodel,
                         model_args=jargs, model_kwargs=jkwargs)
    port = mrw_setup(None, 20, algo, model=model, model_args=args,
                     model_kwargs=kwargs, device="cpu")
    accepted = []

    def compare(ours, nxt):
        np.testing.assert_allclose(ours.z_grad.numpy(), nxt.z_grad,
                                   rtol=1e-4, atol=1e-3)
        accepted.append(float(ours.accept_prob.mean()))

    _replay(port, jsetup, jax.random.split(jax.random.PRNGKey(3), 6), 24,
            compare)
    assert max(accepted) > 0.05  # proposals were accepted along the way


# ---------------------------------------------------------------------------
# level 3 and the executor's contract
# ---------------------------------------------------------------------------

def test_chees_conjugate_normal_posterior():
    y = _normal_data()
    mean, sd = _normal_posterior(y.astype(np.float64))
    m = MCMC(ChEES(normal_model, device="cpu"), num_warmup=300,
             num_samples=300, num_chains=8)
    m.run(0, y)
    mu = m.get_samples(group_by_chain=True)["mu"].numpy()
    assert mu.shape == (8, 300, 2)
    flat = mu.reshape(-1, 2)
    # the Monte Carlo error of the mean at these draws is ~0.005
    np.testing.assert_allclose(flat.mean(0), mean, atol=0.03)
    np.testing.assert_allclose(flat.std(0), sd, rtol=0.1)
    assert np.all(gelman_rubin(mu) < 1.01)
    assert int(m.get_extra_fields()["diverging"].sum()) == 0


def _scalar_model():
    pc.sample("x", dist.Normal(0.0, 1.0))


@pytest.mark.parametrize("kernel", [ChEES, MALA, RWM])
def test_cross_chain_runs_are_lockstep_and_counted(kernel):
    m = MCMC(kernel(_scalar_model, device="cpu"), num_warmup=30,
             num_samples=20, num_chains=3)
    m.run(1)
    extra = m.get_extra_fields(group_by_chain=True)
    steps = extra["num_steps"]
    assert steps.shape == (3, 20)
    assert bool((steps == steps[:1]).all())  # every chain, every draw
    stats = m.stats
    assert stats["num_iterations"] == 50
    # every ensemble leapfrog (MALA/RWM proposal) evaluates every chain
    assert stats["num_grad_evals"] == 3 * stats["num_leapfrog"] \
        + stats["init_grad_evals"]


@pytest.mark.parametrize("kernel", [ChEES, MALA, RWM])
def test_one_host_read_per_warmup_iteration_none_after(kernel):
    setup = kernel(_scalar_model, device="cpu").setup(
        torch.Generator().manual_seed(0), 30)
    draws = [hu.GeneratorDraws(torch.Generator().manual_seed(s))
             for s in range(4)]
    state = setup.init_fn(draws[:3], draws[3])
    reads = setup.host_reads.count
    for _ in range(30):
        state = setup.sample_fn(state, draws[3])
    assert setup.host_reads.count - reads == 30
    for _ in range(10):
        state = setup.sample_fn(state, draws[3])
    assert setup.host_reads.count - reads == 30


def test_cross_chain_sequential_raises():
    m = MCMC(ChEES(_scalar_model, device="cpu"), num_warmup=10,
             num_samples=10, num_chains=2, chain_method="sequential")
    with pytest.raises(ValueError, match="sequential"):
        m.run(0)


def test_cross_chain_thinning_and_extra_fields_aligned():
    m = MCMC(ChEES(_scalar_model, device="cpu"), num_warmup=50,
             num_samples=40, num_chains=2, thinning=4)
    m.run(0)
    x = m.get_samples(group_by_chain=True)["x"]
    extra = m.get_extra_fields(group_by_chain=True)
    assert x.shape == (2, 10)
    for name in ("accept_prob", "diverging", "num_steps", "step_size",
                 "trajectory_length", "potential_energy", "energy"):
        assert extra[name].shape == (2, 10), name
    assert m.get_samples()["x"].shape == (20,)


@pytest.mark.parametrize("kernel", [ChEES, MALA])
def test_one_setup_run_twice_is_bit_identical(kernel):
    x, y = _data(200, 3, 7)
    runs = [MCMC(kernel(logreg_model_glm, device="cpu"), num_warmup=25,
                 num_samples=15, num_chains=3).run(5, x, y=y)
            .get_samples(group_by_chain=True)["w"] for _ in range(2)]
    other = MCMC(kernel(logreg_model_glm, device="cpu"), num_warmup=25,
                 num_samples=15, num_chains=3).run(6, x, y=y) \
        .get_samples(group_by_chain=True)["w"]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], other)


def test_ensemble_entry_points_default_to_cuda_and_wait_for_shards():
    for kernel in (ChEES, MALA, RWM):
        if torch.cuda.is_available():
            assert kernel(_scalar_model).device.type == "cuda"
        else:
            with pytest.raises(ReproError, match=NO_DEVICE):
                kernel(_scalar_model)
        # data_shards has landed: a model without the fused GLM
        # likelihood has no shard structure (RPL302)
        with pytest.raises(ReproError, match="RPL302"):
            MCMC(kernel(_scalar_model, device="cpu", data_shards=2), 2,
                 2).run(0)
