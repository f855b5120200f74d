"""The inference mesh and the data-sharded potential in one process,
against the JAX package.

- ``launch.mesh.make_inference_mesh``: its shapes and its ``RPL301`` cases,
  as tests/test_sharded_mesh.py:87-130 holds the reference's (one rank in
  this process: the mesh builds its own one-rank gloo group).
- ``RPL302`` for ``data_shards`` without a shard-aware potential and for a
  mismatched marker, ``RPL303`` for a data dim that does not divide the
  shards, and ``KernelSetup.data_axis`` as the reference sets it
  (tests/test_sharded_mesh.py:135-246).
- ``glm_potential_partials_ref`` against the reference's
  ``glm_potential_partials``: both families, with and without an offset,
  S in {1, 2, 4}, ``w`` (d,) and (C, d), within
  ``ops.SPECS["glm_potential_grad"].tol``.
- The sharded fused potential's value and gradient against the reference's
  ``_make_sharded_nll`` without a mesh, within the same bound; one process
  under ``chain_method="parallel"`` with mesh (1, 1) and the 1-D mesh gives
  the vectorized run's bytes.
- docs/distributed.md's n = 64, d = 3 model under ``NUTS(...,
  data_shards=4)``, 4 chains: posterior means within MC error of the
  reference's run, split R-hat below 1.01.

The reference's sharded path imports ``repro._compat``'s batch rule, which
breaks on jax 0.9.0; the fixture replaces it with a no-op in this process,
as tests/test_torch_ensemble.py does.
"""
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import jax
import jax.numpy as jnp
from jax import random

import repro._compat
import repro.core as jpc
from repro.core import dist as jdist
from repro.core.infer import MCMC as JMCMC
from repro.core.infer import NUTS as JNUTS
from repro.core.infer.glm import _make_sharded_nll as j_sharded_nll
from repro.core.infer.hmc import hmc_setup as j_hmc_setup
from repro.kernels.glm_potential import (
    glm_potential_partials as j_partials)
import repro_torch.core as pc
from repro_torch.core import dist
from repro_torch.core.errors import ReproValueError
from repro_torch.core.infer import MCMC, NUTS
from repro_torch.core.infer.diagnostics import (effective_sample_size,
                                                gelman_rubin)
from repro_torch.core.infer.hmc import hmc_setup, resolve_data_axis
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.glm_potential import glm_potential_partials_ref
from repro_torch.launch.mesh import make_inference_mesh

TOL = ops.SPECS["glm_potential_grad"].tol
N, D = 64, 3


@pytest.fixture(autouse=True)
def _reference_on_jax_0_9(monkeypatch):
    monkeypatch.setattr(repro._compat,
                        "ensure_optimization_barrier_batch_rule",
                        lambda: None)


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The one-rank group the meshes start lives for this module only."""
    yield
    if tdist.is_initialized():
        tdist.destroy_process_group()


def _docs_data():
    """docs/distributed.md's data, the same arrays in both packages."""
    x = random.normal(random.PRNGKey(0), (N, D))
    y = (random.uniform(random.PRNGKey(1), (N,)) < 0.5).astype(jnp.float32)
    return x, y, torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))


def j_model(x, y):
    w = jpc.sample("w", jdist.Normal(jnp.zeros(D), 1.0).to_event(1))
    jpc.sample("y", jdist.Bernoulli(logits=x @ w), obs=y,
               infer={"potential": "glm"})


def model(x, y):
    w = pc.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
    pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
              infer={"potential": "glm"})


def plain_model():
    pc.sample("x", dist.Normal(torch.zeros(2), 1.0).to_event(1))


# -- RPL301: the mesh ------------------------------------------------------------

def test_make_inference_mesh_default_is_1d_chains():
    mesh = make_inference_mesh(8, devices="cpu")
    assert mesh.mesh_dim_names == ("chains",)
    assert 8 % mesh.shape[0] == 0 and mesh.shape[0] <= tdist.get_world_size()
    assert list(mesh.get_coordinate()) == [0]


def test_make_inference_mesh_2d_axis_names():
    mesh = make_inference_mesh(8, (1, 1), devices="cpu")
    assert mesh.mesh_dim_names == ("chains", "data")
    assert tuple(mesh.shape) == (1, 1)
    assert sharding.dim_size(mesh, "data") == 1


@pytest.mark.parametrize("num_chains,shape", [
    (8, (0, 1)),     # degenerate axis
    (8, (-1, 2)),    # negative axis
    (5, (2, 1)),     # chains not divisible by the chain axis
    (8, (64, 64)),   # more slots than ranks
    (8, (2, 1)),     # more slots than this one rank
])
def test_make_inference_mesh_rejects_bad_shapes(num_chains, shape):
    with pytest.raises(ReproValueError) as e:
        make_inference_mesh(num_chains, shape, devices="cpu")
    assert e.value.code == "RPL301"


@pytest.mark.parametrize("shape", [(2,), (1, 1, 1)])
def test_mesh_shape_must_be_a_pair_under_parallel(shape):
    with pytest.raises(ValueError, match="pair"):
        MCMC(NUTS(plain_model, device="cpu"), 2, 2, num_chains=2,
             chain_method="parallel", mesh_shape=shape)


def test_mesh_shape_needs_parallel():
    with pytest.raises(ValueError, match="parallel"):
        MCMC(NUTS(plain_model, device="cpu"), 2, 2, num_chains=2,
             chain_method="vectorized", mesh_shape=(1, 1))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_inference_mesh(4, (1, 1), devices="cpu")
    assert sharding.chain_placements(mesh) == (Shard(0), Replicate())
    assert sharding.data_placements(mesh) == (Replicate(), Shard(0))
    assert sharding.replicated_placements(mesh) == (Replicate(), Replicate())
    t = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(sharding.local_rows(t, mesh,
                                           sharding.data_placements(mesh)), t)


# -- RPL302 / RPL303 / data_axis ---------------------------------------------------

def test_data_shards_without_glm_marker_raises_rpl302():
    m = MCMC(NUTS(plain_model, data_shards=4, device="cpu"), num_warmup=2,
             num_samples=2, num_chains=2)
    with pytest.raises(ReproValueError) as e:
        m.run(0)
    assert e.value.code == "RPL302"


def test_data_shards_that_do_not_split_the_rows_raise_rpl302():
    _, _, x, y = _docs_data()
    with pytest.warns(UserWarning, match="do not split"):
        with pytest.raises(ReproValueError) as e:
            hmc_setup(torch.Generator().manual_seed(2), 4, model=model,
                      model_args=(x, y), data_shards=5, device="cpu")
    assert e.value.code == "RPL302"


def test_data_shards_mismatched_marker_raises_rpl302():
    def pot(z):
        return 0.0

    pot.data_shards = 8
    with pytest.raises(ReproValueError) as e:
        resolve_data_axis(pot, 4)
    assert e.value.code == "RPL302"
    assert resolve_data_axis(pot, 8) == "data"
    assert resolve_data_axis(pot, None) is None


class _DataMesh:
    """A (1, ranks) mesh as the potential reads it, this rank at data
    coordinate 0 (the potential raises before it gathers)."""

    mesh_dim_names = ("chains", "data")

    def __init__(self, ranks):
        self.shape = (1, ranks)

    def get_local_rank(self, dim):
        return 0

    def get_group(self, dim):
        raise AssertionError("no collective before the shard check")


def test_data_axis_not_dividing_shards_raises_rpl303():
    _, _, x, y = _docs_data()
    setup = hmc_setup(torch.Generator().manual_seed(2), 4, model=model,
                      model_args=(x, y), data_shards=4, device="cpu")
    mesh = _DataMesh(3)
    with pytest.raises(ReproValueError) as e:
        MCMC(NUTS(model, data_shards=4, device="cpu"), 2, 2,
             num_chains=2)._check_data_axis(setup, mesh)
    assert e.value.code == "RPL303"
    with sharding.use_inference_mesh(mesh):
        with pytest.raises(ReproValueError) as e:
            setup.potential_fn(torch.zeros(D))
    assert e.value.code == "RPL303"


@pytest.mark.parametrize("shards", [4, None])
def test_setup_declares_data_axis_as_the_reference(shards):
    jx, jy, x, y = _docs_data()
    want = j_hmc_setup(random.PRNGKey(2), 4, model=j_model,
                       model_args=(jx, jy), data_shards=shards)
    got = hmc_setup(torch.Generator().manual_seed(2), 4, model=model,
                    model_args=(x, y), data_shards=shards, device="cpu")
    assert got.data_axis == want.data_axis
    assert getattr(got.potential_fn, "data_shards", None) == \
        getattr(want.potential_fn, "data_shards", None)


# -- the partials and the sharded potential against the reference ----------------

FAMILIES = [("bernoulli_logit", None), ("normal", 0.7)]


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


@pytest.mark.parametrize("family,scale", FAMILIES)
@pytest.mark.parametrize("use_offset", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("chains", [None, 3])
def test_partials_match_reference(family, scale, use_offset, shards, chains):
    x, y, w, off = _inputs(4096, 7, chains or 1, shards, family)
    off = off if use_offset else None
    tw = torch.from_numpy(w if chains else w[0])
    vals, grads = glm_potential_partials_ref(
        torch.from_numpy(x), torch.from_numpy(y), tw,
        None if off is None else torch.from_numpy(off), scale, family,
        data_shards=shards)
    if chains:
        want = jax.vmap(lambda wc: j_partials(
            x, y, wc, off, scale, family, data_shards=shards))(jnp.asarray(w))
        assert vals.shape == (chains, shards)
        assert grads.shape == (chains, shards, 7)
    else:
        want = j_partials(x, y, jnp.asarray(w[0]), off, scale, family,
                          data_shards=shards)
        assert vals.shape == (shards,) and grads.shape == (shards, 7)
    np.testing.assert_allclose(vals.numpy(), np.asarray(want[0]), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(want[1]), rtol=0,
                               atol=TOL)


def test_partials_rows_must_split_evenly():
    x = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="equal shards"):
        ops.glm_potential_partials(x, torch.zeros(10), torch.zeros(2),
                                   data_shards=4)


def test_partials_route_counts_cuda_shards():
    from repro_torch.kernels.glm_potential import glm_potential_partials_cuda
    assert ops.FUSED["glm_potential_partials"].kernel is \
        glm_potential_partials_cuda
    assert (glm_potential_partials_cuda, "shard_evals") in ops.counters()
    x = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        glm_potential_partials_cuda(x, torch.zeros(8), torch.zeros(2),
                                    data_shards=2)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_potential_matches_reference(shards):
    jx, jy, x, y = _docs_data()
    j_nll = j_sharded_nll(jx, jy, jnp.zeros(N), None, "bernoulli_logit",
                          shards)
    setup = hmc_setup(torch.Generator().manual_seed(2), 4, model=model,
                      model_args=(x, y), data_shards=shards, device="cpu")
    j_prior = jdist.Normal(jnp.zeros(D), 1.0).to_event(1)
    rng = np.random.default_rng(shards)
    zs = (0.7 * rng.standard_normal((5, D))).astype(np.float32)
    for z in zs:
        jv, jg = jax.value_and_grad(
            lambda w: j_nll(w) - j_prior.log_prob(w))(jnp.asarray(z))
        tz = torch.from_numpy(z).requires_grad_(True)
        v = setup.potential_fn(tz)
        (g,) = torch.autograd.grad(v, tz)
        np.testing.assert_allclose(float(v), float(jv), rtol=0, atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=TOL)
    # the batched entry folds each chain as a lone call does
    bv, bg = setup.potential_fn.value_and_grad_batch(torch.from_numpy(zs))
    for c, z in enumerate(zs):
        tz = torch.from_numpy(z).requires_grad_(True)
        v = setup.potential_fn(tz)
        (g,) = torch.autograd.grad(v, tz)
        np.testing.assert_allclose(bv[c].item(), v.item(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(bg[c].numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(1, 1), None])
def test_one_rank_parallel_equals_vectorized(mesh_shape):
    _, _, x, y = _docs_data()

    def run(**kw):
        m = MCMC(NUTS(model, data_shards=4, device="cpu"), num_warmup=10,
                 num_samples=10, num_chains=2, **kw)
        m.run(7, x, y)
        return m

    a = run(chain_method="vectorized")
    b = run(chain_method="parallel", mesh_shape=mesh_shape)
    assert torch.equal(a.get_samples()["w"], b.get_samples()["w"])
    for f in ("z", "potential_energy", "z_grad"):
        assert torch.equal(getattr(a.last_state, f),
                           getattr(b.last_state, f))


def test_docs_model_posterior_matches_reference():
    """docs/distributed.md's model: the port's and the reference's runs
    agree within MC error, and the port's split R-hat is below 1.01."""
    jx, jy, x, y = _docs_data()
    warmup, draws = 100, 250
    jm = JMCMC(JNUTS(j_model, data_shards=4), num_warmup=warmup,
               num_samples=draws, num_chains=4, chain_method="vectorized")
    jm.run(random.PRNGKey(7), jx, jy)
    ref = np.asarray(jm.get_samples(group_by_chain=True)["w"], np.float64)
    m = MCMC(NUTS(model, data_shards=4, device="cpu"), num_warmup=warmup,
             num_samples=draws, num_chains=4)
    m.run(7, x, y)
    got = m.get_samples(group_by_chain=True)["w"].numpy().astype(np.float64)
    assert np.all(gelman_rubin(got) < 1.01), gelman_rubin(got)
    var = got.reshape(-1, D).var(0)
    mc_err = np.sqrt(var / effective_sample_size(got)
                     + ref.reshape(-1, D).var(0)
                     / effective_sample_size(ref))
    diff = np.abs(got.mean((0, 1)) - ref.mean((0, 1)))
    assert np.all(diff < 4 * mc_err), (diff, mc_err)
    assert m.stats["num_grad_evals"] > 0
