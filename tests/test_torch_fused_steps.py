"""The fused sampler steps' plain versions, on the CPU.

- ``nuts_leaf_ref`` is the NUTS tree's eager code moved into one function:
  bit for bit the composite the tree ran before (``velocity_verlet``'s
  leapfrog through ``leapfrog_halfstep_ref``, ``kinetic_energy``, the
  U-turn dots written out below, the next ``leapfrog_halfstep_ref``) on
  the first, even and odd leaves, 1-9 checkpoint rows, D in {1, 33, 54,
  176, 4097}, float32 and float64.
- The same numpy inputs give the closing kick, ``ke``, the next opening
  and the U-turn verdict of the JAX package's ``kinetic_energy``,
  ``velocity_verlet`` and ``_is_turning`` within 1e-6.
- ``mala_accept_ref`` (MALA and RWM, in warmup and after, one chain whose
  proposal potential is ``inf`` and one whose is NaN) against the JAX
  package's MALA/RWM transition from the same draws: within 1e-6, the
  selections exact.
- Launch counts through the user's entry points, the plain versions
  standing in for the kernels: one ``nuts_leaf`` a leapfrog of a tree, one
  ``leapfrog_halfstep`` a subtree, one ``nuts_turning`` a doubling the
  subtree did not stop itself, one ``mala_step`` and one ``mala_accept`` an
  MALA/RWM iteration.

The reference's MALA calls ``hmc_util.shared_draw``, which breaks on jax
0.9.0 at ``repro/_compat.py``; as in ``test_torch_ensemble.py`` a fixture
replaces ``repro._compat.ensure_optimization_barrier_batch_rule`` with a
no-op in this test process only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro._compat
from chip_smoke import same_bits
from repro.core.infer import hmc_util as jhu
from repro.core.infer.mala import MRWAdaptState as JMRWAdaptState
from repro.core.infer.mala import MRWState as JMRWState
from repro.core.infer.mala import _make_sample_fn as j_mrw_sample_fn
from repro_torch.bench.models import logreg_model_glm
from repro_torch.core.infer import MALA, MCMC, NUTS, RWM
from repro_torch.core.infer import hmc_util as hu
from repro_torch.kernels import ops
from repro_torch.kernels.leapfrog import (leapfrog_halfstep_ref,
                                          nuts_leaf_ref, nuts_turning_ref)
from repro_torch.kernels.rwm_mala import mala_accept_ref, mala_step_ref

_F32 = np.float32
DEPTH = 10  # checkpoint rows: an odd leaf 2**9 - 1 reads nine of them


@pytest.fixture(autouse=True)
def _reference_on_jax_0_9(monkeypatch):
    monkeypatch.setattr(repro._compat,
                        "ensure_optimization_barrier_batch_rule",
                        lambda: None)


def _turning_dots_before(inverse_mass_matrix, r_left, r_right, r_sum):
    """The tree's U-turn dots as it formed them before ``nuts_leaf``."""
    r_mid = r_sum - 0.5 * (r_left + r_right)
    return torch.stack([torch.sum(inverse_mass_matrix * r_left * r_mid, -1),
                        torch.sum(inverse_mass_matrix * r_right * r_mid, -1)])


def _quadratic(a, b):
    def potential(z):
        return 0.5 * torch.sum(a * z * z) + torch.dot(b, z)
    return potential


def _leaf_inputs(d, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dtype)

    a = t(rng.uniform(0.5, 2.0, d))
    b = t(0.3 * rng.standard_normal(d))
    m_inv = t(rng.uniform(0.5, 1.5, d))
    z0, r0, r_sum = (t(0.7 * rng.standard_normal(d)) for _ in range(3))
    ckpts = t(0.7 * rng.standard_normal((DEPTH, d)))
    sum_ckpts = t(1.5 * rng.standard_normal((DEPTH, d)))
    return _quadratic(a, b), m_inv, z0, r0, r_sum, ckpts, sum_ckpts


# (name, r_sum given, ckpt_i, (idx_min, idx_max)): odd leaf 2**k - 1 reads
# rows 0..k-1; leaf 5 reads row 1 alone
LEAVES = [("first", False, 0, None), ("even 2", True, 1, None),
          ("even 6", True, 2, None), ("odd 5", True, None, (1, 1))] + [
    (f"odd {2 ** k - 1}", True, None,
     hu._leaf_idx_to_ckpt_idxs(2 ** k - 1)) for k in range(1, 10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 33, 54, 176, 4097])
def test_nuts_leaf_ref_is_the_tree_composite_bitwise(d, dtype):
    potential, m_inv, z0, r0, r_sum0, ckpts, sum_ckpts = \
        _leaf_inputs(d, dtype, d)
    pe_and_grad, vv_update = hu.velocity_verlet(potential)
    for sign in (1.0, -1.0):
        eps = torch.tensor(sign * 0.0625 * 1.3, dtype=dtype)
        pe0, g0 = pe_and_grad(z0)
        # the tree before: velocity_verlet's leapfrog, then its leaf
        nxt = vv_update(eps, m_inv, hu.IntegratorState(z0, r0, pe0, g0))
        ke = hu.kinetic_energy(m_inv, nxt.r)
        want_next = leapfrog_halfstep_ref(nxt.z, nxt.r, nxt.z_grad, m_inv,
                                          eps)
        # the tree now: the opening kick and drift, then the leaf op
        z1, r_half = leapfrog_halfstep_ref(z0, r0, g0, m_inv, eps)
        pe1, g1 = pe_and_grad(z1)
        assert torch.equal(z1, nxt.z) and torch.equal(g1, nxt.z_grad)
        for name, has_sum, ckpt_i, rows in LEAVES:
            r_sum = r_sum0 if has_sum else None
            want_through = nxt.r if r_sum is None else r_sum + nxt.r
            want_ck, want_sck = ckpts.clone(), sum_ckpts.clone()
            parts = [nxt.potential_energy.reshape(1), ke.reshape(1)]
            if ckpt_i is not None:
                want_ck[ckpt_i] = nxt.r
                want_sck[ckpt_i] = want_through
            else:
                lo, hi = rows
                rc = want_ck[lo:hi + 1]
                parts.append(_turning_dots_before(
                    m_inv, rc, nxt.r,
                    want_through - want_sck[lo:hi + 1] + rc).reshape(-1))
            ck, sck = ckpts.clone(), sum_ckpts.clone()
            idx = rows or (0, -1)
            r, through, vals, z_next, r_half_next = nuts_leaf_ref(
                r_half, z1, g1, pe1, m_inv, eps, r_sum, ck, sck, ckpt_i,
                *idx)
            for got, want in ((r, nxt.r), (through, want_through),
                              (vals, torch.cat(parts)), (ck, want_ck),
                              (sck, want_sck), (z_next, want_next[0]),
                              (r_half_next, want_next[1])):
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (name, sign)
            if rows is not None:
                assert vals.shape == (2 + 2 * (rows[1] - rows[0] + 1),)


def _j_quadratic(a, b):
    def potential(z):
        return 0.5 * jnp.sum(a * z * z) + jnp.dot(b, z)
    return potential


@pytest.mark.parametrize("d", [1, 5, 33])
def test_nuts_leaf_ref_matches_reference(d):
    """Closing kick, ke, the next opening and the U-turn verdicts against
    the JAX package's velocity_verlet, kinetic_energy and _is_turning, from
    the same float32 numpy inputs."""
    rng = np.random.default_rng(100 + d)
    a = rng.uniform(0.5, 2.0, d).astype(_F32)
    b = (0.3 * rng.standard_normal(d)).astype(_F32)
    m = rng.uniform(0.5, 1.5, d).astype(_F32)
    z0, r0, r_sum = (0.7 * rng.standard_normal((3, d))).astype(_F32)
    ck = (0.7 * rng.standard_normal((DEPTH, d))).astype(_F32)
    sck = (1.5 * rng.standard_normal((DEPTH, d))).astype(_F32)
    eps = _F32(0.0625)
    jinit, jupdate = jhu.velocity_verlet(_j_quadratic(a, b))
    s0 = jhu.IntegratorState(z0, r0, *jinit(z0))
    s1 = jupdate(eps, jnp.asarray(m), s0)
    s2 = jupdate(eps, jnp.asarray(m), s1)
    r1, g1 = np.asarray(s1.r), np.asarray(s1.z_grad)

    t = torch.from_numpy
    pe_and_grad, _ = hu.velocity_verlet(_quadratic(t(a), t(b)))
    g0 = pe_and_grad(t(z0))[1]
    z1, r_half = leapfrog_halfstep_ref(t(z0), t(r0), g0, t(m),
                                       torch.tensor(eps))
    pe1, grad1 = pe_and_grad(z1)
    close = dict(rtol=1e-6, atol=1e-6)
    lo, hi = hu._leaf_idx_to_ckpt_idxs(7)  # rows 0..2
    r, through, vals, z_next, r_half_next = nuts_leaf_ref(
        r_half, z1, grad1, pe1, t(m), torch.tensor(eps), t(r_sum),
        t(ck.copy()), t(sck.copy()), None, lo, hi)
    np.testing.assert_allclose(r.numpy(), r1, **close)
    np.testing.assert_allclose(vals[0].item(), float(s1.potential_energy),
                               **close)
    np.testing.assert_allclose(vals[1].item(),
                               float(jhu.kinetic_energy(jnp.asarray(m), r1)),
                               **close)
    np.testing.assert_allclose(z_next.numpy(), np.asarray(s2.z), **close)
    np.testing.assert_allclose(r_half_next.numpy(), r1 - 0.5 * eps * g1,
                               **close)
    # every balanced subtree ending here: its left checkpoint against r_k
    dots = vals[2:].numpy().reshape(2, -1)
    verdicts = []
    for j, row in enumerate(range(lo, hi + 1)):
        subtree = (r_sum + r1) - sck[row] + ck[row]
        verdicts.append(bool(jhu._is_turning(jnp.asarray(m), ck[row], r1,
                                             subtree)))
        assert bool(dots[0, j] <= 0 or dots[1, j] <= 0) == verdicts[-1]
    # the merged tree's check
    rr = (0.7 * rng.standard_normal(d)).astype(_F32)
    tot = (ck[0] + rr + r_sum).astype(_F32)
    got = nuts_turning_ref(t(m), t(ck[0]), t(rr), t(tot)).numpy()
    assert bool(got[0] <= 0 or got[1] <= 0) == \
        bool(jhu._is_turning(jnp.asarray(m), ck[0], rr, tot))
    mid = tot - 0.5 * (ck[0] + rr)
    np.testing.assert_allclose(got, [np.dot(m * ck[0], mid),
                                     np.dot(m * rr, mid)], **close)


def _j_wall(z):
    """A quadratic with an infinite potential beyond z[0] = 20 and a NaN
    one below z[0] = -20 (gradients stay finite)."""
    return 0.5 * jnp.sum(z * z) + jnp.where(z[0] > 20.0, jnp.inf, 0.0) \
        + jnp.where(z[0] < -20.0, jnp.nan, 0.0)


def _wall(z):
    return 0.5 * torch.sum(z * z) + torch.where(z[0] > 20.0, torch.inf, 0.0) \
        + torch.where(z[0] < -20.0, torch.nan, 0.0)


class _Replay:
    """The draws of the reference's MALA/RWM ``sample_fn`` from its key."""

    def __init__(self, key):
        _, self.key_noise, self.key_acc = jax.random.split(key, 3)

    def noise(self, c, d):
        return torch.from_numpy(np.array(
            jax.random.normal(self.key_noise, (c, d))))

    def uniforms(self, c):
        keys = jax.random.split(self.key_acc, c)
        return torch.from_numpy(np.array(jax.vmap(jax.random.uniform)(keys)))


@pytest.mark.parametrize("phase", ["warmup", "after"])
@pytest.mark.parametrize("algo", ["MALA", "RWM"])
def test_mala_accept_ref_matches_reference(algo, phase):
    """One MALA/RWM transition of 8 chains in the JAX package against
    ``mala_step_ref``, the potential and ``mala_accept_ref`` from the same
    draws; chain 0 starts behind the infinite wall, chain 1 behind the NaN
    one, so both proposals diverge."""
    c, d, num_warmup = 8, 5, 10
    rng = np.random.default_rng(7)
    z = (0.8 * rng.standard_normal((c, d))).astype(_F32)
    z[0, 0], z[1, 0] = 100.0, -100.0  # past the walls after the drift
    m = rng.uniform(0.5, 1.5, d).astype(_F32)
    eps = _F32({"MALA": 0.4, "RWM": 0.05}[algo])  # some proposals pass
    jvg = jax.vmap(jax.value_and_grad(_j_wall))
    pe, grad = (np.array(x) for x in jvg(jnp.asarray(z)))
    mean_ap = rng.uniform(0.2, 0.9, c).astype(_F32)
    i = 3 if phase == "warmup" else num_warmup + 2
    key = jax.random.PRNGKey(11)
    state = JMRWState(
        i=jnp.asarray(i, jnp.int32), z=jnp.asarray(z),
        potential_energy=jnp.asarray(pe),
        z_grad=jnp.asarray(grad if algo == "MALA" else np.zeros_like(grad)),
        accept_prob=jnp.zeros(c), mean_accept_prob=jnp.asarray(mean_ap),
        diverging=jnp.zeros(c, bool),
        adapt_state=JMRWAdaptState(
            jnp.asarray(eps), jnp.asarray(m),
            jhu.dual_averaging_init(jnp.log(eps)), jhu.welford_init(d)),
        rng_key=key)
    sample_fn = j_mrw_sample_fn(
        _j_wall, num_warmup, jhu.build_adaptation_schedule(num_warmup), algo,
        adapt_step_size=True, adapt_mass_matrix=False,
        target_accept_prob=0.574)
    nxt = jax.device_get(jax.jit(sample_fn)(state))

    draws = _Replay(key)
    zt, mt, grad_t = torch.from_numpy(z), torch.from_numpy(m), \
        torch.from_numpy(grad)
    noise = draws.noise(c, d)
    use_grad = algo == "MALA"
    z_new = mala_step_ref(zt, grad_t if use_grad else None, noise, mt,
                          float(eps))
    pe_new, grad_new = hu.chain_value_and_grad(_wall)(z_new)
    n_post = 0 if i < num_warmup else max(i + 1 - num_warmup, 1)
    (z_out, pe_out, g_out, accept_prob, diverging, mean_out,
     hmean) = mala_accept_ref(
        zt, torch.from_numpy(pe), grad_t if use_grad else None, z_new, pe_new,
        grad_new if use_grad else None, noise if use_grad else None, mt,
        draws.uniforms(c), float(eps), float(_F32(-0.25) / eps),
        torch.from_numpy(mean_ap), n_post)

    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(diverging.numpy(), nxt.diverging)
    assert diverging[:2].all() and not diverging[2:].any()
    np.testing.assert_allclose(accept_prob.numpy(), nxt.accept_prob, **close)
    # selections: each row is the old one or the proposal, exactly, and the
    # same choice as the reference's
    kept = (z_out == zt).all(1)
    assert bool(((z_out == z_new).all(1) | kept).all())
    np.testing.assert_array_equal(kept.numpy(), (nxt.z == z).all(1))
    assert bool(kept[:2].all()) and not bool(kept.all())
    np.testing.assert_allclose(z_out.numpy(), nxt.z, **close)
    assert same_bits(pe_out[kept], torch.from_numpy(pe)[kept])
    assert same_bits(pe_out[~kept], pe_new[~kept])
    np.testing.assert_allclose(pe_out[2:].numpy(), nxt.potential_energy[2:],
                               **close)
    if use_grad:
        assert torch.equal(g_out[kept], grad_t[kept])
        assert torch.equal(g_out[~kept], grad_new[~kept])
        np.testing.assert_allclose(g_out.numpy(), nxt.z_grad, **close)
    else:
        assert g_out is None
    np.testing.assert_allclose(mean_out.numpy(), nxt.mean_accept_prob,
                               **close)
    if phase == "warmup":
        want = 1.0 / jhu.chain_mean(
            1.0 / jnp.clip(jnp.asarray(nxt.accept_prob), min=1e-10))
        np.testing.assert_allclose(float(hmean), float(want), **close)
        assert mean_out is accept_prob
    else:
        assert hmean is None


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
    x = rng.standard_normal((n, d)).astype(_F32)
    w = rng.standard_normal(d).astype(_F32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ w)))).astype(_F32)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_nuts_launches_one_leaf_op_per_leapfrog(monkeypatch):
    leaf = _count(monkeypatch, ops.FUSED, "nuts_leaf")
    turning = _count(monkeypatch, ops.FUSED, "nuts_turning")
    halfstep = _count(monkeypatch, ops.SPECS, "leapfrog_halfstep")
    subtrees = {"n": 0, "unstopped": 0, "halfsteps": 0, "leaves": 0}
    build = hu.iterative_build_subtree

    def counted(*args, **kwargs):
        h0, l0 = len(halfstep), len(leaf)
        tree = build(*args, **kwargs)
        subtrees["n"] += 1
        subtrees["halfsteps"] += len(halfstep) - h0
        assert len(leaf) - l0 == tree.num_proposals
        subtrees["unstopped"] += not (tree.turning or tree.diverging)
        return tree

    monkeypatch.setattr(hu, "iterative_build_subtree", counted)
    x, y = _logreg()
    mcmc = MCMC(NUTS(logreg_model_glm, device="cpu"), num_warmup=15,
                num_samples=15)
    mcmc.run(0, x, y=y)
    stats = mcmc.stats
    assert len(leaf) == stats["num_leapfrog"] > 30
    assert subtrees["halfsteps"] == subtrees["n"] >= 30
    assert len(turning) == subtrees["unstopped"] > 0
    # the rest of leapfrog_halfstep's calls are the step-size search's
    assert len(halfstep) - subtrees["n"] == stats["init_grad_evals"] - 1


@pytest.mark.parametrize("kernel", [MALA, RWM])
def test_mrw_launches_one_proposal_and_one_accept_per_iteration(
        monkeypatch, kernel):
    step = _count(monkeypatch, ops.SPECS, "mala_step")
    accept = _count(monkeypatch, ops.FUSED, "mala_accept")
    x, y = _logreg()
    mcmc = MCMC(kernel(logreg_model_glm, device="cpu"), num_warmup=12,
                num_samples=8, num_chains=4)
    mcmc.run(0, x, y=y)
    assert len(step) == len(accept) == mcmc.stats["num_iterations"] == 20
