"""The port's kernels against the JAX package's: the plain PyTorch versions
against the Pallas kernels in interpret mode and against ``repro.kernels``'
jnp references, on the same numpy inputs.  Bounds are ``OP_TABLE``'s
(1e-6 for the leapfrogs and the MALA/RWM proposal, 5e-3 for the GLM:
float32 sums taken in another order).  The CUDA kernels themselves are
tested in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.glm_potential import glm_potential_grad as j_glm_pallas
from repro.kernels.leapfrog import leapfrog_halfstep as j_leapfrog_pallas
from repro.kernels.leapfrog import \
    leapfrog_halfstep_batch as j_leapfrog_batch_pallas
from repro.kernels.leapfrog import \
    leapfrog_halfstep_batch_ref as j_leapfrog_batch_ref
from repro.kernels.leapfrog import leapfrog_halfstep_ref as j_leapfrog_ref
from repro.kernels.rwm_mala import mala_step as j_mala_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.glm_potential import glm_potential_grad_ref

TOL = {spec.name: spec.tol for spec in ops.OP_TABLE}


def test_op_table_has_the_reference_rows():
    assert [s.name for s in ops.OP_TABLE] == [s.name for s in jops.OP_TABLE]
    for port, ref in zip(ops.OP_TABLE, jops.OP_TABLE):
        assert port.tol == ref.tol and port.bit_identical == ref.bit_identical
        # a row is ported exactly when it names a kernel and a plain version
        assert (port.kernel is None) == (port.ref is None) \
            == (port.route is None)
        if ref.pallas is None:
            assert port.replaces is None
        else:  # the TPU function it replaces, by file:line of its `def`
            path, line = port.replaces.split(":")
            text = open(path).read().splitlines()[int(line) - 1]
            assert text.startswith("def ") or text.startswith("    def ")
    assert ops.PORTED == ("leapfrog_halfstep", "leapfrog_halfstep_batch",
                          "glm_potential_grad", "mala_step", "enum_contract")
    # backward kernels are counted with the rest
    assert set(ops.launch_counts()) == set(ops.PORTED) | set(ops.BACKWARD)


@pytest.mark.parametrize("D", [1, 54, 4099])
def test_leapfrog_plain_matches_pallas_and_ref_f32(D):
    rng = np.random.default_rng(D)
    z, r, g = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    m_inv = rng.uniform(0.5, 2.0, D).astype(np.float32)
    eps = np.float32(0.037)
    zt, rt = ops.leapfrog_halfstep(*(torch.from_numpy(a) for a in (z, r, g, m_inv)),
                               torch.tensor(eps))
    for jz, jr in (j_leapfrog_pallas(z, r, g, m_inv, eps, interpret=True),
                   j_leapfrog_ref(jnp.asarray(z), jnp.asarray(r),
                                  jnp.asarray(g), jnp.asarray(m_inv), eps)):
        np.testing.assert_allclose(zt.numpy(), np.asarray(jz), rtol=0,
                                   atol=TOL["leapfrog_halfstep"])
        np.testing.assert_allclose(rt.numpy(), np.asarray(jr), rtol=0,
                                   atol=TOL["leapfrog_halfstep"])


def test_leapfrog_plain_matches_pallas_f64():
    """f64 chains stay f64: the Pallas kernel computes in
    promote(f64, f32) = f64, and so does the port."""
    rng = np.random.default_rng(64)
    D = 1000
    z, r, g = (rng.standard_normal(D) for _ in range(3))
    m_inv = rng.uniform(0.5, 2.0, D)
    zt, rt = ops.leapfrog_halfstep(*(torch.from_numpy(a) for a in (z, r, g, m_inv)),
                               0.011)
    assert zt.dtype == torch.float64
    with jax.enable_x64(True):
        jz, jr = j_leapfrog_pallas(jnp.asarray(z), jnp.asarray(r),
                                   jnp.asarray(g), jnp.asarray(m_inv), 0.011,
                                   interpret=True)
        jz, jr = np.asarray(jz), np.asarray(jr)
    assert jz.dtype == np.float64
    np.testing.assert_allclose(zt.numpy(), jz, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.numpy(), jr, rtol=0, atol=1e-12)


# ragged ensembles: C not a multiple of the TPU's 8 sublanes, D not of its
# 128 lanes (nor of the Pallas block), and the main paths' shapes
ENSEMBLE_SHAPES = [(1, 1), (3, 130), (5, 4097), (8, 54), (16, 54)]


def _ensemble_inputs(c, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    z, r, g = (rng.standard_normal((c, d)).astype(dtype) for _ in range(3))
    m_inv = rng.uniform(0.5, 2.0, d).astype(dtype)
    return z, r, g, m_inv


@pytest.mark.parametrize("kick", [0.5, 1.0])
@pytest.mark.parametrize("c,d", ENSEMBLE_SHAPES)
def test_leapfrog_batch_plain_matches_pallas_and_ref_f32(c, d, kick):
    z, r, g, m_inv = _ensemble_inputs(c, d, c * d)
    eps = np.float32(0.037)
    zt, rt = ops.leapfrog_halfstep_batch(
        *(torch.from_numpy(a) for a in (z, r, g, m_inv)), float(eps), kick)
    for jz, jr in (
            j_leapfrog_batch_pallas(z, r, g, m_inv, eps, kick,
                                    interpret=True),
            j_leapfrog_batch_ref(*(jnp.asarray(a) for a in (z, r, g, m_inv)),
                                 eps, kick)):
        np.testing.assert_allclose(zt.numpy(), np.asarray(jz), rtol=0,
                                   atol=TOL["leapfrog_halfstep_batch"])
        np.testing.assert_allclose(rt.numpy(), np.asarray(jr), rtol=0,
                                   atol=TOL["leapfrog_halfstep_batch"])


@pytest.mark.parametrize("kick", [0.5, 1.0])
def test_leapfrog_batch_plain_matches_pallas_f64(kick):
    """f64 ensembles stay f64, as the Pallas kernel computes in
    promote(f64, f32) = f64."""
    z, r, g, m_inv = _ensemble_inputs(3, 130, 64, np.float64)
    zt, rt = ops.leapfrog_halfstep_batch(
        *(torch.from_numpy(a) for a in (z, r, g, m_inv)), 0.011, kick)
    assert zt.dtype == rt.dtype == torch.float64
    with jax.enable_x64(True):
        jz, jr = j_leapfrog_batch_pallas(
            *(jnp.asarray(a) for a in (z, r, g, m_inv)), 0.011, kick,
            interpret=True)
        jz, jr = np.asarray(jz), np.asarray(jr)
    assert jz.dtype == np.float64
    np.testing.assert_allclose(zt.numpy(), jz, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rt.numpy(), jr, rtol=0, atol=1e-12)


@pytest.mark.parametrize("with_grad", [True, False])
@pytest.mark.parametrize("c,d", ENSEMBLE_SHAPES)
def test_mala_plain_matches_pallas_and_ref_f32(c, d, with_grad):
    """``grad=None`` is the random walk: no drift term."""
    z, noise, g, m_inv = _ensemble_inputs(c, d, 7 * c + d)
    g = g if with_grad else None
    eps = np.float32(0.021)
    out = ops.mala_step(torch.from_numpy(z),
                        None if g is None else torch.from_numpy(g),
                        torch.from_numpy(noise), torch.from_numpy(m_inv),
                        float(eps))
    jg = None if g is None else jnp.asarray(g)
    for want in (j_mala_pallas(jnp.asarray(z), jg, jnp.asarray(noise),
                               jnp.asarray(m_inv), eps, interpret=True),
                 jref.mala_step(jnp.asarray(z), jg, jnp.asarray(noise),
                                jnp.asarray(m_inv), eps)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL["mala_step"])


@pytest.mark.parametrize("with_grad", [True, False])
def test_mala_plain_matches_pallas_f64(with_grad):
    """Against the Pallas path, which computes in promote(f64, f32) = f64
    (``ref.mala_step`` computes in float32 whatever the input)."""
    z, noise, g, m_inv = _ensemble_inputs(5, 4097, 11, np.float64)
    g = g if with_grad else None
    out = ops.mala_step(torch.from_numpy(z),
                        None if g is None else torch.from_numpy(g),
                        torch.from_numpy(noise), torch.from_numpy(m_inv),
                        0.013)
    assert out.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(j_mala_pallas(
            jnp.asarray(z), None if g is None else jnp.asarray(g),
            jnp.asarray(noise), jnp.asarray(m_inv), 0.013, interpret=True))
    assert want.dtype == np.float64
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-12)


def _glm_inputs(n, d, seed, family):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal(d)).astype(np.float32)
    off = (0.2 * rng.standard_normal(n)).astype(np.float32)
    if family == "bernoulli_logit":
        y = (rng.random(n) < 0.5).astype(np.float32)
    else:
        y = (x @ w + 0.5 * rng.standard_normal(n)).astype(np.float32)
    return x, y, w, off


@pytest.mark.parametrize("family,scale", [("bernoulli_logit", None),
                                          ("normal", 0.7)])
@pytest.mark.parametrize("use_offset", [False, True])
@pytest.mark.parametrize("n,d", [(1001, 7), (2500, 54)])
def test_glm_plain_matches_pallas_and_ref(family, scale, use_offset, n, d):
    """n not a multiple of the Pallas block (2048) nor of 8; d not of 128."""
    x, y, w, off = _glm_inputs(n, d, n + d, family)
    off = off if use_offset else None
    tv, tg = ops.glm_potential_grad(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
        None if off is None else torch.from_numpy(off), scale, family)
    joff = None if off is None else jnp.asarray(off)
    for jv, jg in (
            j_glm_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), joff,
                         scale, family, interpret=True),
            jref.glm_potential_grad(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(w), joff, scale, family)):
        assert abs(float(tv) - float(jv)) <= TOL["glm_potential_grad"]
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=TOL["glm_potential_grad"])


def test_glm_unknown_family_raises():
    x, y, w, _ = _glm_inputs(10, 3, 0, "bernoulli_logit")
    with pytest.raises(ValueError, match="unknown GLM family"):
        glm_potential_grad_ref(torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(w), family="poisson")
