"""ChEES's fused steps' plain versions, on the CPU.

- ``chees_open_ref`` (row 3 with the momentum draw in front) is bit for bit
  the composite ChEES ran before: ``hmc_util.momentum_sample`` then the
  opening ``leapfrog_halfstep_batch_ref``; in place too.
- ``chees_accept_ref`` is bit for bit the eager code ``ensemble.py``'s
  ``sample_fn`` ran after the trajectory before (written out below: the two
  ``kinetic_energy`` calls, the closing half-kick, the test, the selection,
  the running mean, and in warmup ``adapt_update``'s harmonic mean, ChEES
  gradient and ``welford_combine(wf, welford_batch(z))``), in float32 and
  float64, at (8, 54), (1, 1), (3, 130) and (5, 4097), after warmup, in
  warmup and in a middle-window iteration; with a chain whose energy is
  NaN and one whose is inf, an all-divergent ensemble, and a chain at
  ``accept_prob == u`` (rejected).
- The same numpy inputs give the harmonic mean, the ChEES gradient and the
  Welford fold of the JAX package (its ``adapt_update``'s expression,
  ``chees_gradient`` taken from its sample function's closure,
  ``welford_combine(wf, welford_batch(z))``) within 1e-6 relative, the
  tolerance of float32 sums taken in another order.
- Launch counts through the user's entry point, the plain versions
  standing in for the kernels: one ``chees_open``, ``num_steps - 1``
  batch leapfrogs and one ``chees_accept`` a transition; on the CPU the
  trajectory runs eagerly (``MCMC.stats["trajectory_graph"]`` is False).

The reference's ensemble module is built with the in-process patch of
``repro._compat`` that ``tests/test_torch_ensemble.py`` uses.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro._compat
from repro.core.infer import hmc_util as jhu
from repro.core.infer.ensemble import _make_sample_fn as j_chees_sample_fn
from repro_torch.bench.models import logreg_model_glm
from repro_torch.core.infer import MCMC, ChEES
from repro_torch.core.infer import hmc_util as hu
from repro_torch.kernels import ops
from repro_torch.kernels.leapfrog import (chain_sum, chees_accept_ref,
                                          chees_gradient, chees_open_ref,
                                          harmonic_mean_accept,
                                          leapfrog_halfstep_batch_ref)

SHAPES = [(8, 54), (1, 1), (3, 130), (5, 4097)]
DTYPES = [torch.float32, torch.float64]
EPS = 0.0123
H = 0.37


@pytest.fixture(autouse=True)
def _reference_on_jax_0_9(monkeypatch):
    monkeypatch.setattr(repro._compat,
                        "ensure_optimization_barrier_batch_rule",
                        lambda: None)


def _same(a, b):
    """Bit-identical, NaN included."""
    if a is None or b is None:
        return a is b
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _inputs(c, d, dtype, seed):
    """A transition's close as the sampler makes it (see chip_smoke's
    ``chees_operands``): the state, the draw, the trajectory's end after
    one opening and one interior step, potentials that spread accept_prob
    over (0, 1], chain 0's pe1 inf and chain 1's NaN where C >= 3."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dtype)

    z0, g0, n = (t(rng.standard_normal((c, d))) for _ in range(3))
    m = t(rng.uniform(0.5, 1.5, d))
    z1, r = chees_open_ref(z0, n, g0, m, EPS)
    g1 = g0 + 0.2 * t(rng.standard_normal((c, d)))
    z1, r = leapfrog_halfstep_batch_ref(z1, r, g1, m, EPS, 1.0)
    pe0 = t(3.0 * np.abs(rng.standard_normal(c)))
    ke0 = hu.kinetic_energy(m, hu.momentum_sample(n, m))
    ke1 = hu.kinetic_energy(m, r - 0.5 * EPS * g1)
    pe1 = pe0 + ke0 - ke1 + t(0.5 * rng.standard_normal(c))
    if c >= 3:
        pe1[0], pe1[1] = math.inf, math.nan
    u, mean = t(rng.random(c)), t(rng.random(c))
    wf = hu.WelfordState(t(rng.standard_normal(d)),
                         t(np.abs(rng.standard_normal(d))), 40)
    return (z0, pe0, g0, n, m, z1, r, pe1, g1), u, mean, wf


def _former_close(z0, pe0, g0, n, m, z1, r, pe1, g1, eps, u, mean, n_post,
                  h, wf, max_delta_energy=1000.0):
    """``sample_fn``'s eager code after the trajectory before the fused
    close, in its order (the ensemble's state, the draw's momenta, the
    trajectory's end with its closing kick, ``adapt_update``'s reads)."""
    r_open = hu.momentum_sample(n, m)
    energy_cur = pe0 + hu.kinetic_energy(m, r_open)
    r_end = r - 0.5 * eps * g1
    energy_new = pe1 + hu.kinetic_energy(m, r_end)
    delta = torch.where(torch.isnan(energy_new), math.inf,
                        energy_new - energy_cur)
    accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
    diverging = delta > max_delta_energy
    accept = u < accept_prob
    acc2 = accept[:, None]
    z = torch.where(acc2, z1, z0)
    pe = torch.where(accept, pe1, pe0)
    grad = torch.where(acc2, g1, g0)
    energy = torch.where(accept, energy_new, energy_cur)
    if n_post:
        mean_ap = mean + (accept_prob - mean) / n_post
        return z, pe, grad, energy, accept_prob, diverging, mean_ap, None, \
            None
    parts = [harmonic_mean_accept(accept_prob)]
    weights = torch.where(diverging, 0.0, accept_prob)
    parts.append(torch.zeros_like(parts[0]) if h is None else
                 chees_gradient(float(h), z0, z1, m * r_end, weights))
    folded = None
    if wf is not None:
        new = hu.welford_combine(wf, hu.welford_batch(z))
        folded = (new.mean, new.m2)
    return z, pe, grad, energy, accept_prob, diverging, accept_prob, \
        torch.stack(parts), folded


def _close(args, u, mean, wf, mode, eps=EPS):
    """``chees_accept_ref`` and the former composite in ``mode``."""
    n_post, h, fold = {"sampling": (7, None, None),
                       "warmup": (0, H, None),
                       "middle window": (0, H, wf)}[mode]
    welford = None if fold is None else (
        wf.mean, wf.m2, *hu.welford_ratios(wf.n, args[0].shape[0]))
    got = chees_accept_ref(*args, eps, u, 1000.0, mean, n_post, h, welford)
    want = _former_close(*args, eps, u, mean, n_post, h, fold)
    return got, want


def _assert_same(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, tuple) or isinstance(b, tuple):
            assert (a is None) == (b is None), i
            if a is not None:
                assert all(_same(x, y) for x, y in zip(a, b)), i
        else:
            assert _same(a, b), i


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,d", SHAPES)
def test_chees_open_ref_is_the_former_composite_bitwise(c, d, dtype):
    (z0, _, g0, n, m, *_), _, _, _ = _inputs(c, d, dtype, c * d)
    want = leapfrog_halfstep_batch_ref(z0, hu.momentum_sample(n, m), g0, m,
                                       EPS, 0.5)
    got = chees_open_ref(z0, n, g0, m, EPS)
    assert all(_same(a, b) for a, b in zip(got, want))
    # in place, as the graphed trajectory calls it; and a device-scalar eps
    z, r = z0.clone(), torch.empty_like(z0)
    out = chees_open_ref(z, n, g0, m, torch.tensor([EPS], dtype=dtype),
                         out=(z, r))
    assert out[0] is z and out[1] is r
    assert _same(z, want[0]) and _same(r, want[1])
    z, r = want[0].clone(), want[1].clone()
    step = leapfrog_halfstep_batch_ref(z, r, g0, m, EPS, 1.0)
    leapfrog_halfstep_batch_ref(z, r, g0, m, EPS, 1.0, out=(z, r))
    assert _same(z, step[0]) and _same(r, step[1])


@pytest.mark.parametrize("mode", ["sampling", "warmup", "middle window"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,d", SHAPES)
def test_chees_accept_ref_is_the_former_composite_bitwise(c, d, dtype, mode):
    args, u, mean, wf = _inputs(c, d, dtype, 7 * c + d)
    got, want = _close(args, u, mean, wf, mode)
    _assert_same(got, want)
    ap, diverging = got[4], got[5]
    if c >= 3:  # the inf and the NaN energies diverge and are rejected
        assert diverging[:2].all() and (ap[:2] == 0).all()
        assert _same(got[0][:2], args[0][:2])
    if mode == "sampling":
        assert got[7] is None and got[8] is None
    else:
        assert got[6] is ap and got[7].shape == (2,)
        assert (got[8] is None) == (mode == "warmup")
    if c >= 5:
        assert 0 < float(ap[~diverging].min()) < 1  # a spread of choices


@pytest.mark.parametrize("dtype", DTYPES)
def test_chees_accept_ref_all_divergent_and_at_u(dtype):
    args, u, mean, wf = _inputs(8, 54, dtype, 3)
    # every proposal divergent: the gradient has no information, 0
    inf = torch.full_like(args[7], math.inf)
    diverged = args[:7] + (inf,) + args[8:]
    got, want = _close(diverged, u, mean, wf, "middle window")
    _assert_same(got, want)
    assert got[5].all() and float(got[7][1]) == 0.0
    assert _same(got[0], args[0]) and _same(got[2], args[2])
    # a chain whose uniform equals its accept probability is rejected
    got, _ = _close(args, u, mean, wf, "warmup")
    ap = got[4]
    c = int(torch.nonzero((ap > 0) & (ap < 1))[0])
    u_at = u.clone()
    u_at[c] = ap[c]
    got, want = _close(args, u_at, mean, wf, "warmup")
    _assert_same(got, want)
    assert _same(got[0][c], args[0][c]) and _same(got[1][c], args[1][c])
    # a NaN energy at the start: delta NaN, accept_prob NaN, no accept
    nan0 = args[1].clone()
    nan0[2] = math.nan
    got, want = _close((args[0], nan0) + args[2:], u, mean, wf, "warmup")
    _assert_same(got, want)
    assert bool(got[4][2].isnan()) and not bool(got[5][2])


def _gradient_tolerance(args, ap, diverging):
    """1e-6 of the magnitudes summed into the ChEES gradient: each chain's
    three sums over D may move by 1e-6 of its terms' magnitudes, and the
    centring by a float32 rounding of the positions, so h (S1 - S0) S2 by
    h (A1 + A0) A2 with A1, A0, A2 the sums of |z1|^2, |z0|^2 and |z1 v1|,
    weighted over the weight sum (float64)."""
    z0, _, _, n, m, z1, r, _, g1 = (t.double() for t in args)
    weights = torch.where(diverging, 0.0, ap).double()
    keep = (weights > 0)[:, None]
    w_sum = max(float(weights.sum()), 1e-10)
    v1 = torch.where(keep, m * (r - 0.5 * EPS * g1), 0.0)
    z1k = torch.where(keep, z1, 0.0)
    a1, a0 = (z1k * z1k).sum(-1), (z0 * z0).sum(-1)
    a2 = (z1k * v1).abs().sum(-1)
    return 1e-6 * float((weights * H * (a1 + a0) * a2).sum()) / w_sum \
        + 1e-30


def _closure_var(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _j_chees_gradient():
    """The JAX package's ``chees_gradient``, a closure of its sample
    function's ``adapt_update``."""
    sample_fn = j_chees_sample_fn(
        lambda z: 0.5 * jnp.sum(z * z), 20, jhu.build_adaptation_schedule(20),
        adapt_step_size=True, adapt_mass_matrix=True, adapt_trajectory=True,
        target_accept_prob=0.651, learning_rate=0.05, max_num_steps=256)
    return _closure_var(_closure_var(sample_fn, "adapt_update"),
                        "chees_gradient")


@pytest.mark.parametrize("c,d", SHAPES)
def test_chees_statistics_match_reference(c, d):
    """The warmup statistics and the fold against the JAX package's, on the
    same numpy inputs, float32: within 1e-6 relative (float32 sums in
    another order)."""
    args, u, mean, wf = _inputs(c, d, torch.float32, 11 * c + d)
    got, _ = _close(args, u, mean, wf, "middle window")
    z0, _, _, n, m, z1, r, _, g1 = args
    ap, diverging = got[4], got[5]
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(
        ap=ap, z0=z0, z1=z1, m=m, r1=r - 0.5 * EPS * g1, z=got[0],
        mean=wf.mean, m2=wf.m2, div=diverging).items()}
    close = dict(rtol=1e-6, atol=1e-6)
    hmean = 1.0 / jhu.chain_mean(1.0 / jnp.clip(j["ap"], min=1e-10))
    np.testing.assert_allclose(float(got[7][0]), float(hmean), **close)
    weights = jnp.where(j["div"], 0.0, j["ap"])
    v1 = jax.vmap(lambda rr: jhu.velocity(j["m"], rr))(j["r1"])
    jgrad = _j_chees_gradient()(jnp.float32(H), j["z0"], j["z1"], v1,
                                weights)
    assert abs(float(got[7][1]) - float(jgrad)) <= _gradient_tolerance(
        args, ap, diverging)
    jwf = jhu.welford_combine(jhu.WelfordState(j["mean"], j["m2"],
                                               jnp.int32(wf.n)),
                              jhu.welford_batch(j["z"]))
    np.testing.assert_allclose(got[8][0].numpy(), np.asarray(jwf.mean),
                               **close)
    np.testing.assert_allclose(got[8][1].numpy(), np.asarray(jwf.m2),
                               **close)
    assert int(jwf.n) == wf.n + c


def _count(monkeypatch, table, name):
    """Stand a counting plain version in for op ``name``'s."""
    spec = table[name]
    calls = []

    def ref(*args, **kwargs):
        calls.append(1)
        return spec.ref(*args, **kwargs)

    monkeypatch.setitem(table, name, spec._replace(ref=ref))
    return calls


def _logreg(n=200, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_chees_launches_one_open_and_one_accept_per_transition(monkeypatch):
    opening = _count(monkeypatch, ops.FUSED, "chees_open")
    interior = _count(monkeypatch, ops.SPECS, "leapfrog_halfstep_batch")
    accept = _count(monkeypatch, ops.FUSED, "chees_accept")
    x, y = _logreg()
    setup = ChEES(logreg_model_glm, device="cpu").setup(
        torch.Generator().manual_seed(0), 12, model_args=(x,),
        model_kwargs={"y": y})
    draws = [hu.GeneratorDraws(torch.Generator().manual_seed(s))
             for s in range(4)]
    state = setup.init_fn(draws[:3], draws[3])
    calls0 = (len(opening), len(interior), len(accept))
    assert calls0 == (0, 0, 0)  # the searches take other paths
    steps = []
    for _ in range(20):
        before = (len(opening), len(interior), len(accept))
        state = setup.sample_fn(state, draws[3])
        after = (len(opening), len(interior), len(accept))
        assert tuple(a - b for a, b in zip(after, before)) == \
            (1, state.num_steps - 1, 1)
        steps.append(state.num_steps)
    assert max(steps) > 1
    assert setup.sample_fn.trajectory_stats()["trajectory_graph"] is False


def test_chees_run_counts_and_stats_on_cpu(monkeypatch):
    opening = _count(monkeypatch, ops.FUSED, "chees_open")
    interior = _count(monkeypatch, ops.SPECS, "leapfrog_halfstep_batch")
    accept = _count(monkeypatch, ops.FUSED, "chees_accept")
    x, y = _logreg(seed=1)
    mcmc = MCMC(ChEES(logreg_model_glm, device="cpu"), num_warmup=15,
                num_samples=10, num_chains=3)
    mcmc.run(0, x, y=y)
    stats = mcmc.stats
    assert len(opening) == len(accept) == stats["num_iterations"] == 25
    assert len(interior) == stats["num_leapfrog"] - 25
    assert stats["trajectory_graph"] is False
    assert stats["graph_replays"] == {"opening": 0, "interior": 0}
    assert stats["host_syncs"] - 15 >= 0  # one read a warmup iteration
    assert stats["num_grad_evals"] == 3 * stats["num_leapfrog"] \
        + stats["init_grad_evals"]


def test_welford_ratios_are_welford_combines():
    for n_a, n_b in ((0, 8), (40, 8), (7, 3), (1, 1)):
        r_mean, r_m2 = hu.welford_ratios(n_a, n_b)
        n_safe = max(np.float32(n_a) + np.float32(n_b), np.float32(1))
        assert r_mean == float(np.float32(n_b) / n_safe)
        assert r_m2 == float(np.float32(n_a) * np.float32(n_b) / n_safe)


def test_chain_sum_folds_pairwise():
    x = torch.arange(1.0, 8.0).reshape(7, 1) * torch.tensor([[1.0, 1e8]])
    # halves added with the odd row carried: ((1+4)+(3+6)) + ((2+5)+7)
    assert torch.equal(chain_sum(x), ((x[0] + x[3]) + (x[2] + x[5]))
                       + ((x[1] + x[4]) + x[6]))
