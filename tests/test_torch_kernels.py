"""The port's kernels against the JAX package's: the plain PyTorch versions
against the Pallas kernels in interpret mode and against ``repro.kernels``'
jnp references, on the same numpy inputs.  Bounds are ``OP_TABLE``'s
(1e-6 for the leapfrogs and the MALA/RWM proposal, 5e-3 for the GLM:
float32 sums taken in another order; 2e-5 for rmsnorm and 2e-4 for
attention in float32; in bfloat16 one rounding step, see
``kernels/ops.py:BF16_RTOL``).  The CUDA kernels themselves are
tested in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import _flash_fwd_impl as j_flash_fwd
from repro.kernels.glm_potential import glm_potential_grad as j_glm_pallas
from repro.kernels.leapfrog import leapfrog_halfstep as j_leapfrog_pallas
from repro.kernels.leapfrog import \
    leapfrog_halfstep_batch as j_leapfrog_batch_pallas
from repro.kernels.leapfrog import \
    leapfrog_halfstep_batch_ref as j_leapfrog_batch_ref
from repro.kernels.leapfrog import leapfrog_halfstep_ref as j_leapfrog_ref
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm_pallas
from repro.kernels.rwm_mala import mala_step as j_mala_pallas
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.kernels.glm_potential import glm_potential_grad_ref

TOL = {spec.name: spec.tol for spec in ops.OP_TABLE}


def test_op_table_has_the_reference_rows():
    assert [s.name for s in ops.OP_TABLE] == [s.name for s in jops.OP_TABLE]
    for port, ref in zip(ops.OP_TABLE, jops.OP_TABLE):
        assert port.tol == ref.tol and port.bit_identical == ref.bit_identical
        # a row with a TPU kernel is ported exactly when it names a kernel
        # and a plain version; a ref-only row never has a kernel or route
        assert (port.kernel is None) == (port.route is None)
        if ref.pallas is None:
            assert port.replaces is None and port.kernel is None
        else:  # the TPU function it replaces, by file:line of its `def`
            assert (port.kernel is None) == (port.ref is None)
            path, line = port.replaces.split(":")
            text = open(path).read().splitlines()[int(line) - 1]
            assert text.startswith("def ") or text.startswith("    def ")
    assert ops.PORTED == ("attention", "leapfrog_halfstep",
                          "leapfrog_halfstep_batch", "glm_potential_grad",
                          "mala_step", "enum_contract", "rmsnorm",
                          "softmax_xent", "ssd_scan")
    # every row with a TPU kernel is ported
    assert set(ops.PORTED) == {s.name for s in jops.OP_TABLE if s.pallas}
    # backward kernels are counted with the rest; each names its plain
    # version and, where the JAX package has one, the TPU kernel's function
    assert set(ops.launch_counts()) == set(ops.PORTED) | set(ops.BACKWARD)
    for name, spec in ops.BACKWARD.items():
        assert spec.name == name and spec.kernel and spec.ref
        assert spec.route == "cuda"
        if spec.replaces is not None:
            path, line = spec.replaces.split(":")
            text = open(path).read().splitlines()[int(line) - 1]
            assert text.startswith("def ")
    assert ops.BACKWARD["enum_contract_bwd"].replaces is None


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


def _close(got, want, dtype, tol):
    """float32: max-abs within ``tol``; bfloat16: elementwise within one
    bfloat16 rounding step of the float32-computed value."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        bound = ops.BF16_RTOL * np.abs(want) + ops.BF16_ATOL
        assert np.all(np.abs(got - want) <= bound), float(
            np.max(np.abs(got - want) - bound))


def _pair(x, dtype):
    """The same numpy float32 values as a JAX and a torch array of
    ``dtype`` (both round to bfloat16 to nearest-even)."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape,dtype,pallas", [
    ((4, 64, 128), "float32", True),     # tests/test_kernels.py:60-64
    ((2, 256, 512), "float32", True),
    ((8, 128), "bfloat16", True),
    ((3, 7, 96), "float32", False),      # ragged rows: the port takes any
    ((2, 5, 4096), "bfloat16", False),   # the LM's width
])
def test_rmsnorm_plain_matches_pallas_and_ref(shape, dtype, pallas):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = ops.rmsnorm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    wants = [jref.rmsnorm(jx, jnp.asarray(w))]
    if pallas:
        wants.append(j_rmsnorm_pallas(jx, jnp.asarray(w), 1e-6, True))
    for want in wants:
        _close(got.float().numpy(), want.astype(jnp.float32), dtype,
               TOL["rmsnorm"])


@pytest.mark.parametrize("S,H,K,dq,dv,causal,dtype", [
    (128, 4, 4, 64, 64, True, "float32"),     # MHA (test_kernels.py:20-27)
    (256, 4, 2, 64, 64, True, "float32"),     # GQA
    (128, 4, 1, 64, 64, True, "float32"),     # MQA
    (128, 4, 4, 96, 64, True, "float32"),     # MLA-shaped dq != dv
    (128, 2, 2, 64, 64, False, "float32"),    # bidirectional
    (256, 4, 2, 64, 64, True, "bfloat16"),    # bf16
])
def test_flash_attention_plain_matches_pallas(S, H, K, dq, dv, causal, dtype):
    """``o`` and ``lse`` of the plain version against the Pallas forward
    (``_flash_fwd_impl``, the function the CUDA kernel replaces) in
    interpret mode, and ``o`` against ``ref.attention``."""
    B = 2
    rng = np.random.default_rng(S + H + K + dq + dv)
    q = rng.standard_normal((B, S, H, dq)).astype(np.float32)
    k = rng.standard_normal((B, S, K, dq)).astype(np.float32)
    v = rng.standard_normal((B, S, K, dv)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    o, lse = flash.flash_attention_ref(tq, tk, tv, causal=causal)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, S)
    assert torch.equal(ops.attention(tq, tk, tv, causal=causal), o)
    bq = min(128, S)
    jo, jlse = j_flash_fwd(jq, jk, jv, dq ** -0.5, causal, bq, bq, True)
    _close(o.float().numpy(), jo.astype(jnp.float32), dtype,
           TOL["attention"])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=TOL["attention"])
    _close(o.float().numpy(), jref.attention(jq, jk, jv, causal=causal)
           .astype(jnp.float32), dtype, TOL["attention"])


def test_sliding_window_attention_matches_ref():
    """``window > 0`` takes the plain version, as the JAX package's does."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)), window=7)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          window=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("H,K,dq,dv,per_row_mask", [
    (4, 4, 32, 32, False), (8, 2, 64, 64, True), (4, 1, 96, 64, False)])
def test_decode_attention_plain_matches_ref(H, K, dq, dv, per_row_mask):
    """The ref-only op against ``ref.decode_attention`` within 1e-5
    (float32, one softmax in another summation order)."""
    B, S = 3, 37
    rng = np.random.default_rng(H * K + dq)
    q = rng.standard_normal((B, 1, H, dq)).astype(np.float32)
    k = rng.standard_normal((B, S, K, dq)).astype(np.float32)
    v = rng.standard_normal((B, S, K, dv)).astype(np.float32)
    if per_row_mask:
        mask = rng.random((B, S)) < 0.5
        mask[:, 0] = True
    else:
        mask = (np.arange(S) <= 20)[None, :]
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(mask))
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask))
    assert tuple(got.shape) == (B, 1, H, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
