"""The port's discrete enumeration against the JAX package's, on the same
numpy inputs:

- ``enum_contract``: the plain version against ``repro.kernels.ref`` and
  the Pallas kernel in interpret mode (1e-6, float32), and the
  ``EnumContract`` gradient against ``jax.grad`` of the reference, with
  ``gradcheck`` in float64 and exact zeros (not NaN) in masked rows and
  columns;
- the distributions and the stick-breaking bijection the HMMs need;
- the enum-aware ``log_density`` and flat potential (value and gradient)
  of a Gaussian mixture and of ``markov``'s fully-latent HMM, and
  ``markov``'s guards;
- level 2: NUTS transitions of ``enum_hmm_model`` replayed from the
  reference's state and draws;
- level 3: posterior means of the semi-supervised ``hmm_model`` within 4
  Monte Carlo standard errors of the reference's (supervision removes the
  label switching that rules this check out for ``enum_hmm_model``).

The CUDA kernels themselves are tested in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as jpc
from benchmarks.models import enum_hmm_model as j_enum_hmm_model
from benchmarks.models import hmm_model as j_hmm_model
from repro.core import dist as jdist
from repro.core.dist.transforms import StickBreakingTransform as JStick
from repro.core.infer import MCMC as JMCMC
from repro.core.infer import NUTS as JNUTS
from repro.core.infer import initialize_model_structure as j_init_structure
from repro.core.infer import log_density as j_log_density
from repro.core.infer.hmc import nuts_setup as j_nuts_setup
from repro.kernels import ref as jref
from repro.kernels.enum_contract import enum_contract as j_enum_pallas
from repro_torch import core as pc
from repro_torch.bench.models import (enum_hmm_data, enum_hmm_model,
                                      hmm_data, hmm_model)
from repro_torch.core import dist
from repro_torch.core.dist.transforms import StickBreakingTransform, biject_to
from repro_torch.core.handlers import seed, trace
from repro_torch.core.infer import (MCMC, NUTS, config_enumerate,
                                    effective_sample_size,
                                    initialize_model_structure, log_density,
                                    markov, nuts_setup)
from repro_torch.core.infer.hmc_util import value_and_grad
from repro_torch.interop import state_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.enum_contract import (EnumChain, EnumContract,
                                               enum_contract_bwd_ref,
                                               enum_contract_ref)
from test_torch_nuts import ReplayDraws

TOL = 1e-6  # float32 parity bound of the plain version (OP_TABLE's 0 is
#             the kernel against the plain version, on the card)
GRAD_TOL = 1e-5  # float32 gradient sums over K terms taken in another order

@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: intra-op threads only add contention (several
    times slower under the suite's parallel workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the shapes of tests/test_kernels.py:268-270
SHAPES = [((), 2, 2), ((), 3, 3), ((), 16, 16), ((), 128, 128), ((), 7, 13),
          ((), 257, 5), ((4,), 8, 8), ((2, 3), 5, 5)]


def _inputs(batch, ki, k, seed_, dtype=np.float32):
    rng = np.random.default_rng(seed_)
    return (rng.standard_normal(batch + (ki,)).astype(dtype),
            rng.standard_normal(batch + (ki, k)).astype(dtype))


def _masked():
    a, m = _inputs((), 3, 4, 1)
    a[1] = -np.inf
    m[:, 2] = -np.inf
    return a, m


# --- enum_contract -----------------------------------------------------------

@pytest.mark.parametrize("batch,ki,k", SHAPES + [("masked", 3, 4)])
def test_enum_contract_plain_matches_reference_and_pallas(batch, ki, k):
    a, m = _masked() if batch == "masked" else _inputs(batch, ki, k, ki * k)
    ours = enum_contract_ref(torch.from_numpy(a), torch.from_numpy(m))
    # the autograd Function takes the plain version on the CPU, exactly
    assert torch.equal(ops.enum_contract(torch.from_numpy(a),
                                         torch.from_numpy(m)), ours)
    for theirs in (jref.enum_contract(jnp.asarray(a), jnp.asarray(m)),
                   j_enum_pallas(jnp.asarray(a), jnp.asarray(m),
                                 interpret=True)):
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape
        np.testing.assert_array_equal(np.isneginf(ours.numpy()),
                                      np.isneginf(theirs))
        finite = np.isfinite(theirs)
        np.testing.assert_allclose(ours.numpy()[finite], theirs[finite],
                                   rtol=0, atol=TOL)
    if batch == "masked":
        assert bool(torch.isneginf(ours[2]))


@pytest.mark.parametrize("batch,ki,k", [s for s in SHAPES if s[1] < 100])
def test_enum_contract_grad_matches_jax_grad(batch, ki, k):
    a, m = _inputs(batch, ki, k, 7 + ki)
    g = np.random.default_rng(k).standard_normal(batch + (k,)).astype(
        np.float32)
    at, mt = (torch.from_numpy(v).requires_grad_(True) for v in (a, m))
    (EnumContract.apply(at, mt) * torch.from_numpy(g)).sum().backward()
    ja, jm = jax.grad(lambda x, y: jnp.sum(jref.enum_contract(x, y) * g),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(m))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ja),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(jm),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("a_shape,m_shape", [((5,), (5, 4)),
                                             ((3,), (2, 3, 4)),
                                             ((2, 1, 3), (4, 3, 3))])
def test_enum_contract_gradcheck_f64(a_shape, m_shape):
    rng = np.random.default_rng(len(m_shape))
    a = torch.from_numpy(rng.standard_normal(a_shape)).requires_grad_(True)
    m = torch.from_numpy(rng.standard_normal(m_shape)).requires_grad_(True)
    assert torch.autograd.gradcheck(EnumContract.apply, (a, m))


def test_enum_contract_masked_gradients_are_zero():
    a, m = (torch.from_numpy(v).requires_grad_(True) for v in _masked())
    out = EnumContract.apply(a, m)
    assert bool(torch.isneginf(out[2]))
    out[torch.isfinite(out)].sum().backward()
    for grad in (a.grad, m.grad):
        assert not torch.isnan(grad).any()
    assert float(a.grad[1]) == 0.0
    assert float(m.grad[1].abs().max()) == 0.0
    assert float(m.grad[:, 2].abs().max()) == 0.0
    # the plain backward alone, with a nonzero cotangent on the -inf column
    d_a, d_m = enum_contract_bwd_ref(a.detach(), m.detach(), out.detach(),
                                     torch.ones(4))
    assert not torch.isnan(d_a).any() and float(d_m[:, 2].abs().max()) == 0


# --- distributions -----------------------------------------------------------

def _close(ours, theirs, tol=1e-5):
    assert tuple(ours.shape) == tuple(np.shape(theirs))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=tol, atol=tol)


def test_distributions_and_stick_breaking_match_reference():
    rng = np.random.default_rng(3)
    conc = rng.uniform(0.5, 3.0, (4, 5)).astype(np.float32)
    value = rng.dirichlet(np.ones(5), size=4).astype(np.float32)
    probs = rng.dirichlet(np.ones(6), size=(2, 3)).astype(np.float32)
    logits = (2 * rng.standard_normal((2, 3, 6))).astype(np.float32)
    idx = rng.integers(0, 6, (2, 3))
    t = torch.from_numpy
    _close(dist.Dirichlet(t(conc)).log_prob(t(value)),
           jdist.Dirichlet(conc).log_prob(value))
    _close(dist.Dirichlet(t(conc)).to_event(1).log_prob(t(value)),
           jdist.Dirichlet(conc).to_event(1).log_prob(value))
    _close(dist.Categorical(probs=t(probs)).log_prob(t(idx)),
           jdist.Categorical(probs=probs).log_prob(idx))
    _close(dist.Categorical(logits=t(logits)).log_prob(t(idx)),
           jdist.Categorical(logits=logits).log_prob(idx))
    # broadcast of an enumerated value against the batch shape
    col = np.arange(6).reshape(6, 1, 1)
    _close(dist.Categorical(probs=t(probs)).log_prob(t(col)),
           jdist.Categorical(probs=probs).log_prob(col))
    _close(dist.Delta(t(value[0]), log_density=t(conc[0])).log_prob(
        t(value[0])), jdist.Delta(value[0], conc[0]).log_prob(value[0]))
    assert float(dist.Delta(0.0).log_prob(torch.tensor(1.0))) == -np.inf
    for expand in (False, True):
        for ours, theirs in (
                (dist.Categorical(probs=t(probs)),
                 jdist.Categorical(probs=probs)),
                (dist.Bernoulli(probs=t(probs[..., 0])),
                 jdist.Bernoulli(probs=probs[..., 0])),
                (dist.Categorical(probs=t(probs[0, 0])).expand((4, 2)),
                 jdist.Categorical(probs=probs[0, 0]).expand((4, 2)))):
            np.testing.assert_array_equal(
                ours.enumerate_support(expand).numpy(),
                np.asarray(theirs.enumerate_support(expand)))
    assert dist.Categorical(probs=t(probs)).has_enumerate_support
    assert not dist.Dirichlet(t(conc)).to_event(1).has_enumerate_support
    sb, jsb = StickBreakingTransform(), JStick()
    assert isinstance(biject_to(dist.Dirichlet(t(conc)).support),
                      StickBreakingTransform)
    u = (0.7 * rng.standard_normal((4, 4))).astype(np.float32)
    y = sb(t(u))
    _close(y, jsb(u))
    _close(y.sum(-1), np.ones(4))
    _close(sb.inv(t(value)), jsb.inv(value), 1e-4)
    _close(sb.log_abs_det_jacobian(t(u), y),
           jsb.log_abs_det_jacobian(u, jsb(u)))


def test_categorical_and_dirichlet_sample_from_the_generator():
    probs = torch.tensor([0.1, 0.6, 0.3])
    a = dist.Categorical(probs=probs).sample(torch.Generator().manual_seed(0),
                                             (20000,))
    b = dist.Categorical(probs=probs).sample(torch.Generator().manual_seed(0),
                                             (20000,))
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=3).double() / a.numel()
    assert float((freq - probs.double()).abs().max()) < 0.02
    d = dist.Dirichlet(torch.full((2, 3), 2.0))
    x = d.sample(torch.Generator().manual_seed(1), (5000,))
    assert x.shape == (5000, 2, 3)
    assert torch.allclose(x.sum(-1), torch.ones(5000, 2))
    assert float((x.mean(0) - 1 / 3).abs().max()) < 0.02
    state = torch.random.get_rng_state()
    d.sample(torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), state)


# --- enum-aware log_density and the flat potential ---------------------------

K_GMM = 3
WEIGHTS = np.array([0.2, 0.5, 0.3], np.float32)


def _gmm(x):
    mu = pc.sample("mu", dist.Normal(torch.zeros(K_GMM),
                                     torch.ones(K_GMM)).to_event(1))
    with pc.plate("data", x.shape[0]):
        z = pc.sample("z", dist.Categorical(probs=torch.from_numpy(WEIGHTS)),
                      infer={"enumerate": "parallel"})
        pc.sample("obs", dist.Normal(mu[z], 1.0), obs=x)


def _j_gmm(x):
    mu = jpc.sample("mu", jdist.Normal(jnp.zeros(K_GMM),
                                       jnp.ones(K_GMM)).to_event(1))
    with jpc.plate("data", x.shape[0]):
        z = jpc.sample("z", jdist.Categorical(probs=WEIGHTS),
                       infer={"enumerate": "parallel"})
        jpc.sample("obs", jdist.Normal(mu[z], 1.0), obs=x)


def _potentials(model, j_model, args, j_args):
    pot = initialize_model_structure(torch.Generator().manual_seed(0), model,
                                     args)[0]
    jpot = j_init_structure(jax.random.PRNGKey(0), j_model, j_args)[0]
    return pot, jpot


def _assert_potentials_agree(pot, jpot, dim, seed_, n=3):
    rng = np.random.default_rng(seed_)
    j_value_and_grad = jax.jit(jax.value_and_grad(jpot))
    for _ in range(n):
        z = (0.7 * rng.standard_normal(dim)).astype(np.float32)
        pe, g = value_and_grad(pot)(torch.from_numpy(z))
        jpe, jg = j_value_and_grad(jnp.asarray(z))
        np.testing.assert_allclose(float(pe), float(jpe), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_gmm_enum_log_density_and_potential_match_reference():
    x = (2 * np.random.default_rng(0).standard_normal(7)).astype(np.float32)
    mus = np.array([-2.0, 0.0, 2.0], np.float32)
    lp, tr = log_density(_gmm, (torch.from_numpy(x),), {},
                         {"mu": torch.from_numpy(mus)})
    jlp, jtr = j_log_density(_j_gmm, (jnp.asarray(x),), {},
                             {"mu": jnp.asarray(mus)})
    np.testing.assert_allclose(float(lp), float(jlp), rtol=1e-6)
    assert tr["z"]["infer"]["_enumerate_dim"] \
        == jtr["z"]["infer"]["_enumerate_dim"] == -2
    assert tuple(tr["z"]["value"].shape) == (K_GMM, 1)
    pot, jpot = _potentials(_gmm, _j_gmm, (torch.from_numpy(x),),
                            (jnp.asarray(x),))
    _assert_potentials_agree(pot, jpot, K_GMM, 1)


def _torch_data(data):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in data.items()}


def _jax_data(data):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in data.items()}


def test_markov_enum_hmm_log_density_and_potential_match_reference():
    data = enum_hmm_data(3, seed=1, T=30)
    rng = np.random.default_rng(2)
    params = {"theta": rng.dirichlet(np.ones(3), 3).astype(np.float32),
              "phi": rng.dirichlet(np.ones(16), 3).astype(np.float32)}
    lp, tr = log_density(enum_hmm_model, (_torch_data(data),), {},
                         {k: torch.from_numpy(v) for k, v in params.items()})
    jlp, jtr = j_log_density(j_enum_hmm_model, (_jax_data(data),), {},
                             {k: jnp.asarray(v) for k, v in params.items()})
    # the terms are O(100) in float32 and cancel to O(0.1)
    np.testing.assert_allclose(float(lp), float(jlp), rtol=0, atol=1e-4)
    assert list(tr) == list(jtr) == ["theta", "phi", "markov_marginal"]
    pot, jpot = _potentials(enum_hmm_model, j_enum_hmm_model,
                            (_torch_data(data),), (_jax_data(data),))
    _assert_potentials_agree(pot, jpot, 3 * 2 + 3 * 15, 3)


def test_markov_simulation_path_and_guards():
    theta = torch.tensor([[0.6, 0.3, 0.1], [0.2, 0.5, 0.3], [0.3, 0.3, 0.4]])
    phi = torch.full((3, 5), 0.2)
    w = torch.tensor([0, 1, 4, 2, 3, 1])

    def step(z_prev, w_t):
        z = pc.sample("z", dist.Categorical(probs=theta[z_prev]))
        pc.sample("w", dist.Categorical(probs=phi[z]), obs=w_t)
        return z

    with trace() as tr:
        states = seed(lambda ww: markov(step, 0, ww, name="chain"), 5)(w)
    assert states.shape == (6,)
    assert "chain/0/z" in tr and "chain/5/w" in tr

    # the guards of tests/test_enum.py:273
    def in_plate(ww):
        with pc.plate("batch", 2):
            markov(step, 0, ww)

    with pytest.raises(NotImplementedError, match="plate"):
        log_density(config_enumerate(in_plate), (w,), {}, {})

    def cont_inside(ww):
        def bad_step(z_prev, w_t):
            loc = pc.sample("loc", dist.Normal(0.0, 1.0))
            z = pc.sample("z", dist.Categorical(probs=theta[z_prev]))
            pc.sample("w", dist.Normal(loc + z, 1.0), obs=w_t.float())
            return z
        markov(bad_step, 0, ww)

    with pytest.raises(RuntimeError, match="markov transition"):
        log_density(cont_inside, (w,), {}, {})

    def no_state(ww):
        def empty_step(z_prev, w_t):
            pc.sample("w", dist.Categorical(probs=phi[z_prev]), obs=w_t)
            return z_prev
        markov(empty_step, 0, ww)

    with pytest.raises(ValueError, match="exactly one"):
        log_density(no_state, (w,), {}, {})


# --- NUTS on the enumerated HMM ----------------------------------------------

def test_nuts_transitions_replay_reference_enum_hmm():
    """Each transition starts from the reference's state and replays its
    draws: the same ``z``, ``num_steps``, ``accept_prob`` and divergence."""
    data = enum_hmm_data(3, seed=4, T=12)
    setup = j_nuts_setup(jax.random.PRNGKey(0), 10, model=j_enum_hmm_model,
                         model_args=(_jax_data(data),))
    port = nuts_setup(None, 10, model=enum_hmm_model,
                      model_args=(_torch_data(data),), device="cpu")
    state = setup.init_fn(jax.random.PRNGKey(3))
    sample_fn = jax.jit(setup.sample_fn)
    steps = []
    for _ in range(4):
        ref = jax.device_get(state)
        nxt = jax.device_get(sample_fn(state))
        ours = port.sample_fn(state_from_reference(ref, "cpu"),
                              ReplayDraws(ref.rng_key))
        np.testing.assert_allclose(ours.z.numpy(), nxt.z, rtol=1e-4,
                                   atol=1e-4)
        assert ours.num_steps == int(nxt.num_steps)
        assert bool(ours.diverging) == bool(nxt.diverging)
        np.testing.assert_allclose(float(ours.accept_prob),
                                   float(nxt.accept_prob), atol=1e-4)
        steps.append(ours.num_steps)
        state = sample_fn(state)
    assert max(steps) > 1  # the replay went through real trees


def test_enum_hmm_run_launches_one_contraction_per_step_and_gradient(
        monkeypatch):
    """The invariant chip_smoke.py gates on the card: each potential
    gradient contracts the chain's T-1 steps in one ``EnumChain`` forward
    and one backward (one launch of each chain kernel on a card), and no
    one-step ``EnumContract`` runs on the path."""
    calls = {}
    for cls in (EnumChain, EnumContract):
        for method in ("forward", "backward"):
            key = f"{cls.__name__}.{method}"
            calls[key] = 0

            def counted(ctx, *args, _real=getattr(cls, method), _key=key):
                calls[_key] += 1
                return _real(ctx, *args)

            monkeypatch.setattr(cls, method, staticmethod(counted))
    T = 12
    m = MCMC(NUTS(enum_hmm_model, max_tree_depth=4, device="cpu"),
             num_warmup=5, num_samples=5)
    m.run(0, enum_hmm_data(2, seed=5, T=T, V=4))
    evals = m.stats["num_grad_evals"]
    assert evals >= m.stats["num_leapfrog"] > 0
    assert calls == {"EnumChain.forward": evals, "EnumChain.backward": evals,
                     "EnumContract.forward": 0, "EnumContract.backward": 0}
    theta = m.get_samples()["theta"]
    assert theta.shape == (5, 2, 2) and torch.isfinite(theta).all()
    assert torch.allclose(theta.sum(-1), torch.ones(5, 2))


@pytest.mark.parametrize("T,T_sup", [(60, 20), (101, 100), (100, 100),
                                     (600, 100)])
def test_hmm_potential_matches_reference(T, T_sup):
    """The semi-supervised HMM's potential and gradient against the JAX
    model's: its forward pass multiplies the chain's log-space transfer
    matrices as a balanced tree where the reference scans them in order
    (an even chain, one step, none, and the paper's 500).  The gradient is
    held to 5e-4 of its largest entry: float32 over 500 chained steps,
    taken in either order, drifts ~2e-4 of it (the in-order loop does as
    much); a wrong step or transposed matrix moves it by O(1)."""
    data = hmm_data(seed=0, T=T, T_sup=T_sup)
    pot, jpot = _potentials(hmm_model, j_hmm_model, (_torch_data(data),),
                            (_jax_data(data),))
    j_value_and_grad = jax.jit(jax.value_and_grad(jpot))
    rng = np.random.default_rng(3)
    for _ in range(3):
        z = (0.7 * rng.standard_normal(3 * 2 + 3 * 9)).astype(np.float32)
        pe, g = value_and_grad(pot)(torch.from_numpy(z))
        jpe, jg = j_value_and_grad(jnp.asarray(z))
        jg = np.asarray(jg)
        np.testing.assert_allclose(float(pe), float(jpe), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=5e-4 * np.max(np.abs(jg)))


def test_hmm_posterior_matches_reference_run():
    data = hmm_data(seed=0, T=60, T_sup=20)
    m = MCMC(NUTS(hmm_model, device="cpu"), num_warmup=80, num_samples=80)
    m.run(0, data)
    th = m.get_samples(group_by_chain=True)["theta"].numpy()
    jm = JMCMC(JNUTS(j_hmm_model), num_warmup=80, num_samples=80)
    jm.run(jax.random.PRNGKey(0), _jax_data(data))
    jth = np.asarray(jm.get_samples(group_by_chain=True)["theta"])
    mean, jmean = th.mean((0, 1)), jth.mean((0, 1))
    se = np.sqrt(th.std((0, 1)) ** 2 / effective_sample_size(th)
                 + jth.std((0, 1)) ** 2 / effective_sample_size(jth))
    assert np.all(np.abs(mean - jmean) <= 4 * se), (mean, jmean, se)
    assert int(m.get_extra_fields()["diverging"].sum()) == 0
