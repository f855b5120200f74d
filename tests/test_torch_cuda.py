"""The port's CUDA kernel wrappers: what runs without a card (they refuse
CPU tensors, a build without nvcc raises) and, on a card (``-m cuda``),
each kernel against its plain version.  No JAX here, so the file also runs
on a machine that has a card and no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.enum_contract import (EnumContract,
                                               enum_contract_bwd_cuda,
                                               enum_contract_bwd_ref,
                                               enum_contract_cuda,
                                               enum_contract_ref)
from repro_torch.kernels.glm_potential import (glm_potential_grad_cuda,
                                               glm_potential_grad_ref)
from repro_torch.kernels.leapfrog import (leapfrog_halfstep_batch_cuda,
                                          leapfrog_halfstep_batch_ref,
                                          leapfrog_halfstep_cuda,
                                          leapfrog_halfstep_ref)
from repro_torch.kernels.rwm_mala import mala_step_cuda, mala_step_ref

TOL = {spec.name: spec.tol for spec in ops.OP_TABLE}


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


def test_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers take the plain version only for CPU tensors; the CUDA
    wrappers themselves never run on one."""
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        leapfrog_halfstep_cuda(z, z, z, z, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        glm_potential_grad_cuda(torch.zeros(3, 2), torch.zeros(3),
                                torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        enum_contract_cuda(torch.zeros(3), torch.zeros(3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        enum_contract_bwd_cuda(torch.zeros(3), torch.zeros(3, 4),
                               torch.zeros(4), torch.zeros(4))
    zz = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        leapfrog_halfstep_batch_cuda(zz, zz, zz, torch.ones(4), 0.1, 1.0)
    for grad in (zz, None):
        with pytest.raises(ValueError, match="CUDA"):
            mala_step_cuda(zz, grad, zz, torch.ones(4), 0.1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "_LOADED", {})
    for name in ("leapfrog", "enum_contract", "leapfrog_batch", "mala_step"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load(name)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    for D, dtype in ((54, torch.float32), (1_000_003, torch.float64)):
        gen = torch.Generator().manual_seed(D)
        z, r, g = (torch.randn(D, generator=gen, dtype=dtype).to(dev)
                   for _ in range(3))
        m_inv = torch.rand(D, generator=gen, dtype=dtype).to(dev) + 0.5
        eps = torch.tensor(0.01, dtype=dtype, device=dev)
        a = leapfrog_halfstep_cuda(z, r, g, m_inv, eps)
        b = leapfrog_halfstep_ref(z, r, g, m_inv, eps)
        for u, v in zip(a, b):
            assert float((u - v).abs().max()) <= TOL["leapfrog_halfstep"]
    for family, scale in (("bernoulli_logit", None), ("normal", 0.7)):
        x, y, w, off = (torch.from_numpy(a).to(dev)
                        for a in _glm_inputs(1001, 7, 3, family))
        kv, kg = glm_potential_grad_cuda(x, y, w, off, scale, family)
        pv, pg = glm_potential_grad_ref(x, y, w, off, scale, family,
                                        compute_dtype=torch.float64)
        assert abs(float(kv) - float(pv)) <= TOL["glm_potential_grad"]
        assert float((kg - pg).abs().max()) <= TOL["glm_potential_grad"]


ENUM_SHAPES = [((), 8, 8), ((), 2, 2), ((), 3, 3), ((), 16, 16),
               ((), 128, 128), ((), 7, 13), ((), 257, 5), ((4,), 8, 8),
               ((2, 3), 5, 5), ((), 1, 6), ((16384,), 64, 64)]


def _enum_inputs(batch, ki, k, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(batch + (ki,))
    m = rng.standard_normal(batch + (ki, k))
    return torch.from_numpy(a).to(dtype), torch.from_numpy(m).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_enum_contract_kernels_match_plain_on_card(dtype):
    """Forward bit-identical to the plain version on the card (OP_TABLE's
    bit_identical row), backward within 1e-6 relative, masked rows and
    columns giving -inf and zero gradients, never NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    assert ops.SPECS["enum_contract"].bit_identical
    dev = torch.device("cuda")
    cases = [_enum_inputs(b, ki, k, dtype, i)
             for i, (b, ki, k) in enumerate(ENUM_SHAPES)]
    a, m = _enum_inputs((), 3, 4, dtype, 99)
    a[1] = -float("inf")
    m[:, 2] = -float("inf")
    cases.append((a, m))
    for a, m in cases:
        a, m = a.to(dev), m.to(dev)
        out = enum_contract_cuda(a, m)
        assert torch.equal(out, enum_contract_ref(a, m))
        g = torch.from_numpy(np.random.default_rng(7).standard_normal(
            tuple(out.shape))).to(dtype).to(dev)
        da, dm = enum_contract_bwd_cuda(a, m, out, g)
        ra, rm = enum_contract_bwd_ref(a, m, out, g)
        for got, want in ((da, ra), (dm, rm)):
            assert not torch.isnan(got).any()
            err = (got - want).abs() / (1.0 + want.abs())
            assert float(err.max()) <= 1e-6
    # the masked case: -inf column, zero gradients in the masked row/column
    assert bool(torch.isneginf(out[2]))
    assert float(dm[1].abs().max()) == 0.0 and float(dm[:, 2].abs().max()) \
        == 0.0 and float(da[1]) == 0.0
    # the autograd Function routes CUDA tensors to the kernels
    ops.reset_launch_counts()
    a, m = (t.to(dev).requires_grad_(True)
            for t in _enum_inputs((), 8, 8, dtype, 3))
    EnumContract.apply(a, m).sum().backward()
    counts = ops.launch_counts()
    assert counts["enum_contract"] == 1 and counts["enum_contract_bwd"] == 1


# the main paths' ensembles (ChEES 8 chains, MALA/RWM 16) and ragged ones
ENSEMBLE_SHAPES = [(8, 54), (16, 54), (1, 1), (3, 130), (5, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ensemble_kernels_match_plain_on_card(dtype):
    """The batch leapfrog (kick 0.5 and 1.0) and the MALA/RWM proposal
    (with and without grad) against their plain versions within OP_TABLE's
    1e-6; each launch counted; a device-tensor eps and a bad kick refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    ops.reset_launch_counts()
    for i, (c, d) in enumerate(ENSEMBLE_SHAPES):
        rng = np.random.default_rng(i)
        z, r, g, noise = (torch.from_numpy(rng.standard_normal((c, d)))
                          .to(dtype).to(dev) for _ in range(4))
        m_inv = torch.from_numpy(rng.uniform(0.5, 2.0, d)).to(dtype).to(dev)
        for kick in (0.5, 1.0):
            got = leapfrog_halfstep_batch_cuda(z, r, g, m_inv, 0.0123, kick)
            want = leapfrog_halfstep_batch_ref(z, r, g, m_inv, 0.0123, kick)
            for a, b in zip(got, want):
                assert a.dtype == dtype
                assert float((a - b).abs().max()) <= \
                    TOL["leapfrog_halfstep_batch"]
        for grad in (g, None):
            got = mala_step_cuda(z, grad, noise, m_inv, 0.0071)
            want = mala_step_ref(z, grad, noise, m_inv, 0.0071)
            assert float((got - want).abs().max()) <= TOL["mala_step"]
    counts = ops.launch_counts()
    n = len(ENSEMBLE_SHAPES)
    assert counts["leapfrog_halfstep_batch"] == 2 * n
    assert counts["mala_step"] == 2 * n
    with pytest.raises(ValueError, match="host number"):
        leapfrog_halfstep_batch_cuda(z, r, g, m_inv,
                                     torch.tensor(0.1, device=dev))
    with pytest.raises(ValueError, match="kick"):
        leapfrog_halfstep_batch_cuda(z, r, g, m_inv, 0.1, 0.25)
