"""The port's CUDA kernel wrappers: what runs without a card (they refuse
CPU tensors, a build without nvcc raises) and, on a card (``-m cuda``),
each kernel against its plain version.  No JAX here, so the file also runs
on a machine that has a card and no JAX."""
import numpy as np
import pytest
import torch

from chip_smoke import (ENS_SHAPES, NUTS_BATCH_CHAINS, NUTS_BATCH_SIZES,
                        NUTS_LEAVES, NUTS_SIZES, accept_operands,
                        accept_prob_tolerance, chees_checks, leaf_scales,
                        nuts_batch_checks, same_bits, trajectory_checks)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels.enum_contract import (EnumContract,
                                               enum_chain_bwd_cuda,
                                               enum_chain_bwd_ref,
                                               enum_chain_cuda,
                                               enum_chain_ref,
                                               enum_contract_bwd_cuda,
                                               enum_contract_bwd_ref,
                                               enum_contract_cuda,
                                               enum_contract_ref)
from repro_torch.kernels.glm_potential import (glm_potential_grad_cuda,
                                               glm_potential_grad_ref,
                                               glm_potential_partials_cuda)
from repro_torch.kernels.leapfrog import (chees_accept_cuda, chees_open_cuda,
                                          leapfrog_halfstep_batch_cuda,
                                          leapfrog_halfstep_batch_ref,
                                          leapfrog_halfstep_cuda,
                                          leapfrog_halfstep_ref,
                                          halfstep_chains_cuda,
                                          nuts_leaf_batch_cuda,
                                          nuts_leaf_cuda, nuts_leaf_ref,
                                          nuts_turning_batch_cuda,
                                          nuts_turning_cuda, nuts_turning_ref)
from repro_torch.kernels import softmax_xent as xent
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_ref,
                                         rmsnorm_cuda, rmsnorm_ref)
from repro_torch.kernels.rwm_mala import (harmonic_mean_accept,
                                         mala_accept_cuda, mala_accept_ref,
                                         mala_step_cuda, mala_step_ref)
from repro_torch.kernels import ssd_scan as ssd

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
    c2, on = torch.zeros(2), torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        halfstep_chains_cuda(zz, zz, zz, zz, c2, on)
    with pytest.raises(ValueError, match="CUDA"):
        nuts_leaf_batch_cuda(zz, zz, zz, c2, zz, c2, on, None,
                             torch.zeros(2, 3, 4), torch.zeros(2, 3, 4), 0)
    with pytest.raises(ValueError, match="CUDA"):
        nuts_turning_batch_cuda(zz, zz, zz, zz)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "_LOADED", {})
    for name in ("leapfrog", "enum_contract", "leapfrog_batch", "mala_step",
                 "rmsnorm", "flash_attention", "ssd_scan"):
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


def _glm_referee_tol(x, y, w, off, scale, family):
    """chip_smoke.py's bound against the float64 referee: float32 sums over
    n rows in another order, so the error scales with the sum of the
    magnitudes of the summed terms (5e-3 + 1e-5 of it), per chain."""
    xd, wd = x.double(), w.double()
    logits = xd @ wd + off.double()
    if family == "bernoulli_logit":
        resid = torch.sigmoid(logits) - y.double()
        terms = torch.nn.functional.softplus(logits) - y.double() * logits
    else:
        resid = (logits - y.double()) / scale ** 2
        terms = 0.5 * ((logits - y.double()) / scale) ** 2 + np.log(scale)
    return (TOL["glm_potential_grad"] + 1e-5 * float(terms.abs().sum()),
            TOL["glm_potential_grad"]
            + 1e-5 * (resid.abs()[:, None] * xd.abs()).sum(0))


GLM_SHAPES = [(581_012, 54), (1001, 7), (1001, 54), (1001, 256), (3, 54),
              (3, 7), (3, 256)]
# 40 > the 16 chains a CTA takes: three chain groups
GLM_CHAINS = [1, 3, 8, 16, 40]


@pytest.mark.cuda
@pytest.mark.parametrize("family,scale", [("bernoulli_logit", None),
                                          ("normal", 0.7)])
@pytest.mark.parametrize("n,d", GLM_SHAPES)
def test_glm_chains_kernel_matches_plain_on_card(n, d, family, scale):
    """Every chain of a C-chain launch within the float64 referee's bound
    and bit-identical to a 1-chain launch on its own w; repeated launches
    bit-identical; an unaligned x (4-byte copies) bit-identical to an
    aligned one; one launch a call, C chain evaluations."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    off = torch.from_numpy((0.2 * rng.standard_normal(n)).astype(np.float32))
    w_all = torch.from_numpy(
        (0.3 * rng.standard_normal((max(GLM_CHAINS), d))).astype(np.float32))
    if family == "bernoulli_logit":
        y = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    else:
        y = x @ w_all[0] + 0.5 * torch.from_numpy(
            rng.standard_normal(n).astype(np.float32))
    x, y, off, w_all = x.to(dev), y.to(dev), off.to(dev), w_all.to(dev)
    singles = [glm_potential_grad_cuda(x, y, w_all[c], off, scale, family)
               for c in range(max(GLM_CHAINS))]
    for c, (v1, g1) in enumerate(singles[:3]):
        pv, pg = glm_potential_grad_ref(x, y, w_all[c], off, scale, family,
                                        compute_dtype=torch.float64)
        tol_v, tol_g = _glm_referee_tol(x, y, w_all[c], off, scale, family)
        assert abs(float(v1) - float(pv)) <= tol_v
        assert bool(((g1.double() - pg).abs() <= tol_g).all())
    for chains in GLM_CHAINS:
        w = w_all[:chains].contiguous()
        glm_potential_grad_cuda.launches = 0
        glm_potential_grad_cuda.chain_evals = 0
        nll, grad = glm_potential_grad_cuda(x, y, w, off, scale, family)
        assert (glm_potential_grad_cuda.launches,
                glm_potential_grad_cuda.chain_evals) == (1, chains)
        assert nll.shape == (chains,) and grad.shape == (chains, d)
        for c in range(chains):
            assert torch.equal(nll[c], singles[c][0])
            assert torch.equal(grad[c], singles[c][1])
        nll2, grad2 = glm_potential_grad_cuda(x, y, w, off, scale, family)
        assert torch.equal(nll, nll2) and torch.equal(grad, grad2)
    # x one float past a 16-byte boundary: every copy takes 4 bytes
    buf = torch.empty(n * d + 1, dtype=torch.float32, device=dev)
    xu = buf[1:].view(n, d)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    w = w_all[:8].contiguous()
    got = glm_potential_grad_cuda(xu, y, w, off, scale, family)
    want = glm_potential_grad_cuda(x, y, w, off, scale, family)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = glm_potential_grad_cuda(x, y, w, None, scale, family)
    ref = glm_potential_grad_ref(x, y, w, None, scale, family,
                                 compute_dtype=torch.float64)
    tol_v, _ = _glm_referee_tol(x, y, w[0], torch.zeros_like(off), scale,
                                family)
    assert float((got[0].double() - ref[0]).abs().max()) <= tol_v


@pytest.mark.cuda
@pytest.mark.parametrize("family,scale", [("bernoulli_logit", None),
                                          ("normal", 0.7)])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7])
def test_glm_partials_kernel_matches_shard_launches_on_card(shards, family,
                                                            scale):
    """``glm_potential_partials_cuda``: one launch and C * S shard
    evaluations a call; shard k of chain c bit-identical to a one-shard
    launch on the rows ``x[k m:(k + 1) m]`` (unaligned for odd k: 13 * 4 *
    m is not a multiple of 16) and within the float64 referee's bound;
    rows that do not split evenly raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    n, d = 7 * 4 * 3 * 101, 13
    x, y, _, off = (torch.from_numpy(a).to(dev)
                    for a in _glm_inputs(n, d, shards, family))
    rng = np.random.default_rng(shards)
    w_all = torch.from_numpy((0.3 * rng.standard_normal((40, d)))
                             .astype(np.float32)).to(dev)
    m = n // shards
    for chains in (1, 5, 16, 40):
        w = w_all[:chains].contiguous()
        glm_potential_partials_cuda.launches = 0
        glm_potential_partials_cuda.shard_evals = 0
        nll, grad = glm_potential_partials_cuda(x, y, w, off, scale, family,
                                                data_shards=shards)
        assert (glm_potential_partials_cuda.launches,
                glm_potential_partials_cuda.shard_evals) \
            == (1, chains * shards)
        assert nll.shape == (chains, shards)
        assert grad.shape == (chains, shards, d)
        for k in range(shards):
            rows = slice(k * m, (k + 1) * m)
            v, g = glm_potential_grad_cuda(x[rows], y[rows], w, off[rows],
                                           scale, family)
            assert torch.equal(nll[:, k], v) and torch.equal(grad[:, k], g)
            pv, pg = glm_potential_grad_ref(x[rows], y[rows], w[0],
                                            off[rows], scale, family,
                                            compute_dtype=torch.float64)
            tol_v, tol_g = _glm_referee_tol(x[rows], y[rows], w[0],
                                            off[rows], scale, family)
            assert abs(float(nll[0, k]) - float(pv)) <= tol_v
            assert bool(((grad[0, k].double() - pg).abs() <= tol_g).all())
    one = glm_potential_partials_cuda(x, y, w_all[0], off, scale, family,
                                      data_shards=shards)
    assert one[0].shape == (shards,) and one[1].shape == (shards, d)
    if shards > 1:
        with pytest.raises(ValueError, match="equal shards"):
            glm_potential_partials_cuda(x[:-1], y[:-1], w_all[0], off[:-1],
                                        scale, family, data_shards=shards)


@pytest.mark.cuda
def test_glm_wrapper_refuses_bad_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    x, y = torch.zeros(5, 257, device=dev), torch.zeros(5, device=dev)
    with pytest.raises(ValueError, match="d <= 256"):
        glm_potential_grad_cuda(x, y, torch.zeros(257, device=dev))
    x = torch.zeros(5, 3, device=dev)
    with pytest.raises(ValueError, match="chains"):
        glm_potential_grad_cuda(x, y, torch.zeros(257, 3, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        glm_potential_grad_cuda(x.cpu(), y, torch.zeros(2, 3, device=dev))


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


def test_chain_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        enum_chain_cuda(torch.zeros(3), torch.zeros(4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        enum_chain_bwd_cuda(torch.zeros(4, 3, 3), torch.zeros(5, 3),
                            torch.zeros(3))


# (T, batch, K): the main path's chain, T = 2 and 1, both sides of the
# warp/CTA split and of the CTA kernels' whole-matrix/row-chunk split
CHAIN_SHAPES = [(120, (), 8), (2, (), 8), (1, (), 8), (40, (), 3),
                (5, (), 32), (5, (), 33), (4, (), 128), (3, (), 257),
                (12, (4,), 8), (7, (2, 3), 5), (7, (2,), 9), (5, (), 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_enum_chain_kernels_match_plain_and_one_step_on_card(dtype):
    """The chain forward bit-identical to the plain chain and to T-1
    one-step launches; the chain backward bit-identical to T-1 one-step
    backward launches and within (T-1) x 1e-6 of each output's largest
    entry of the plain chain backward; one launch each, none at T = 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    assert ops.FUSED["enum_chain"].bit_identical
    dev = torch.device("cuda")
    for i, (T, batch, k) in enumerate(CHAIN_SHAPES):
        rng = np.random.default_rng(i)
        a, m, g = (torch.from_numpy(rng.standard_normal(shape)).to(
            dtype).to(dev) for shape in (batch + (k,),
                                         (T - 1,) + batch + (k, k),
                                         batch + (k,)))
        ops.reset_launch_counts()
        alphas = enum_chain_cuda(a, m)
        d_a, d_m = enum_chain_bwd_cuda(m, alphas, g)
        counts = ops.launch_counts()
        assert counts["enum_chain"] == counts["enum_chain_bwd"] == int(T > 1)
        assert torch.equal(alphas, enum_chain_ref(a, m))
        steps = [a]
        for mat in m.unbind(0):
            steps.append(enum_contract_cuda(steps[-1], mat))
        assert torch.equal(alphas, torch.stack(steps))
        grad, d_steps = g, []
        for t in range(T - 2, -1, -1):
            grad, d_mat = enum_contract_bwd_cuda(steps[t], m[t], steps[t + 1],
                                                 grad)
            d_steps.append(d_mat)
        assert torch.equal(d_a, grad)
        assert T == 1 or torch.equal(d_m, torch.stack(d_steps[::-1]))
        r_a, r_m = enum_chain_bwd_ref(m, alphas, g)
        tol = max(T - 1, 1) * 1e-6
        for got, want in ((d_a, r_a), (d_m, r_m)):
            if want.numel():
                assert not torch.isnan(got).any()
                assert float((got - want).abs().max()) \
                    <= tol * float(want.abs().max())
    # the autograd Function routes CUDA tensors to the chain kernels
    ops.reset_launch_counts()
    a, m = (torch.from_numpy(np.random.default_rng(9).standard_normal(
        shape)).to(dtype).to(dev).requires_grad_(True)
        for shape in ((8,), (119, 8, 8)))
    ops.enum_chain(a, m).sum().backward()
    counts = ops.launch_counts()
    assert counts["enum_chain"] == 1 and counts["enum_chain_bwd"] == 1
    assert counts["enum_contract"] == 0 and counts["enum_contract_bwd"] == 0


# the main paths' ensembles (ChEES 8 chains, MALA/RWM 16) and ragged ones
ENSEMBLE_SHAPES = [(8, 54), (16, 54), (1, 1), (3, 130), (5, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ensemble_kernels_match_plain_on_card(dtype):
    """The batch leapfrog (kick 0.5 and 1.0) and the MALA/RWM proposal
    (with and without grad) against their plain versions within OP_TABLE's
    1e-6; each launch counted; the batch leapfrog's eps read from a device
    tensor as from the host number it stages; a bad kick refused."""
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
    on_card = leapfrog_halfstep_batch_cuda(
        z, r, g, m_inv, torch.tensor([0.1], dtype=dtype, device=dev))
    by_value = leapfrog_halfstep_batch_cuda(z, r, g, m_inv, 0.1)
    assert all(same_bits(a, b) for a, b in zip(on_card, by_value))
    with pytest.raises(ValueError, match="eps"):
        leapfrog_halfstep_batch_cuda(z, r, g, m_inv,
                                     torch.zeros(2, dtype=dtype, device=dev))
    with pytest.raises(ValueError, match="kick"):
        leapfrog_halfstep_batch_cuda(z, r, g, m_inv, 0.1, 0.25)


def test_chees_wrappers_refuse_cpu_tensors():
    zz, c, m = torch.zeros(2, 4), torch.zeros(2), torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        chees_open_cuda(zz, zz, zz, m, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        chees_accept_cuda(zz, c, zz, zz, m, zz, zz, c, zz, 0.1, c, 1000.0, c,
                          3)
    with pytest.raises(ValueError, match="n_post"):
        chees_accept_cuda(zz, c, zz, zz, m, zz, zz, c, zz, 0.1, c, 1000.0, c,
                          3, h=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chees_kernels_match_plain_on_card(dtype):
    """Row 3 with its device eps bit-identical to the by-value form and the
    plain version; ``chees_open`` and ``chees_accept`` (after warmup, in
    warmup, with the gradient, the Welford fold, an all-divergent
    ensemble) against their plain versions at the ensembles' shapes: the
    sums over D within 1e-6 of their terms, the rest bit-identical for the
    kernel's accept_prob (``chip_smoke.chees_checks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    results, _ = chees_checks(torch.device("cuda"), ENSEMBLE_SHAPES,
                              (dtype,))
    assert len(results) == 7 * len(ENSEMBLE_SHAPES)


@pytest.mark.cuda
def test_graphed_chees_trajectory_matches_eager_on_card():
    """The CUDA-graph replays of ChEES's trajectory bit-identical to the
    same functions run eagerly, 1 and 5 steps at 8 chains, and the launch
    counters moved by what ran (``chip_smoke.trajectory_checks``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    from repro_torch.bench.models import covtype_data
    results = trajectory_checks(torch.device("cuda"),
                                covtype_data(seed=0, n=4000, d=54))
    assert [r["steps"] for r in results] == [1, 5, 5]
    assert results[-1]["graph_replays"] == {"opening": 2, "interior": 7}


@pytest.mark.cuda
def test_chees_run_replays_its_trajectory_on_card():
    """A ChEES run on the card: its trajectory replays from the two graphs,
    one ``chees_open`` and one ``chees_accept`` a transition, the batch
    leapfrog once an interior step, every counter equal to what ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import MCMC, ChEES
    data = covtype_data(seed=0, n=4000, d=6)
    ops.reset_launch_counts()
    mcmc = MCMC(ChEES(logreg_model_glm), num_warmup=40, num_samples=20,
                num_chains=4)
    mcmc.run(0, data["x"], y=data["y"])
    counts, stats = ops.launch_counts(), mcmc.stats
    iterations, leapfrogs = stats["num_iterations"], stats["num_leapfrog"]
    assert stats["trajectory_graph"] is True
    assert counts["chees_open"] == counts["chees_accept"] == iterations
    assert counts["leapfrog_halfstep_batch"] == leapfrogs - iterations
    replays, eager = stats["graph_replays"], stats["graph_eager_bodies"]
    assert replays["opening"] + eager["opening"] == iterations
    assert replays["interior"] + eager["interior"] == leapfrogs - iterations
    init = stats["init_grad_evals"]
    assert stats["num_grad_evals"] == 4 * leapfrogs + init
    assert counts["glm_potential_grad"] == leapfrogs + init + 1
    w = mcmc.get_samples()["w"]
    assert w.shape == (80, 6) and bool(torch.isfinite(w).all())


def test_fused_step_wrappers_refuse_cpu_tensors():
    z, ck = torch.zeros(4), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        nuts_leaf_cuda(z, z, z, torch.zeros(()), z, 0.1, None, ck, ck, 0)
    with pytest.raises(ValueError, match="CUDA"):
        nuts_turning_cuda(z, z, z, z)
    zz, c = torch.zeros(2, 4), torch.zeros(2)
    for grad in (zz, None):
        with pytest.raises(ValueError, match="CUDA"):
            mala_accept_cuda(zz, c, grad, zz, c, grad, grad, torch.ones(4),
                             c, 0.1, -2.5, c, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nuts_leaf_kernels_match_plain_on_card(dtype):
    """nuts_leaf and nuts_turning against their plain versions on the card:
    vectors and checkpoint rows bit-identical, pe copied, ke and the dots
    within 1e-6 of their terms' magnitudes, repeated calls bit-identical;
    one launch a call."""
    dev = _need_card()
    ops.reset_launch_counts()
    calls = 0
    for d in NUTS_SIZES:
        gen = torch.Generator().manual_seed(d)

        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, generator=gen,
                                        dtype=dtype)).to(dev)

        r_half, z, g, r_sum = (rand(d) for _ in range(4))
        m = (torch.rand(d, generator=gen, dtype=dtype) + 0.5).to(dev)
        ck, sck = rand(8, d), rand(8, d, scale=2.0)
        pe = torch.tensor(1.75, dtype=dtype, device=dev)
        for eps_value in (0.0123, -0.0123):
            eps = torch.tensor(eps_value, dtype=dtype, device=dev)
            for has_sum, ckpt_i, rows in NUTS_LEAVES:
                args = (r_half, z, g, pe, m, eps,
                        r_sum if has_sum else None)
                idx = rows or (0, -1)
                ck_k, sck_k, ck_p, sck_p = (t.clone() for t in
                                            (ck, sck, ck, sck))
                got = nuts_leaf_cuda(*args, ck_k, sck_k, ckpt_i, *idx)
                want = nuts_leaf_ref(*args, ck_p, sck_p, ckpt_i, *idx)
                again = nuts_leaf_cuda(*args, ck.clone(), sck.clone(),
                                       ckpt_i, *idx)
                calls += 2
                torch.cuda.synchronize()
                for i in (0, 1, 3, 4):
                    assert same_bits(got[i], want[i]), (d, ckpt_i, rows, i)
                    assert same_bits(again[i], got[i])
                assert same_bits(ck_k, ck_p) and same_bits(sck_k, sck_p)
                assert same_bits(got[2], again[2])
                assert got[2].shape == want[2].shape
                assert float(got[2][0]) == float(want[2][0])
                scale = leaf_scales(m, want, ck, sck, rows)
                err = (got[2][1:].double() - want[2][1:].double()).abs().cpu()
                assert bool((err <= 1e-6 * scale).all()), (d, rows, err)
        r_left, r_right, total = rand(d), rand(d), rand(d, scale=3.0)
        got = nuts_turning_cuda(m, r_left, r_right, total)
        want = nuts_turning_ref(m, r_left, r_right, total)
        mid = total - 0.5 * (r_left + r_right)
        scale = torch.stack([(m * r_left * mid).abs().sum(),
                             (m * r_right * mid).abs().sum()]).double()
        assert same_bits(nuts_turning_cuda(m, r_left, r_right, total), got)
        assert bool(((got.double() - want.double()).abs()
                     <= 1e-6 * scale).all())
    counts = ops.launch_counts()
    assert counts["nuts_leaf"] == calls
    assert counts["nuts_turning"] == 2 * len(NUTS_SIZES)


@pytest.mark.cuda
def test_nuts_leaf_wrappers_refuse_bad_operands_on_card():
    dev = _need_card()
    z, ck = torch.zeros(8, device=dev), torch.zeros(4, 8, device=dev)
    pe = torch.zeros((), device=dev)
    with pytest.raises(TypeError, match="float32/float64"):
        nuts_leaf_cuda(z.half(), z.half(), z.half(), pe, z.half(), 0.1, None,
                       ck.half(), ck.half(), 0)
    with pytest.raises(ValueError, match="grad"):
        nuts_leaf_cuda(z, z, z[:7], pe, z, 0.1, None, ck, ck, 0)
    with pytest.raises(ValueError, match="r_ckpts"):
        nuts_leaf_cuda(z, z, z, pe, z, 0.1, None, ck[:, :7], ck, 0)
    with pytest.raises(ValueError, match="ckpt_i"):
        nuts_leaf_cuda(z, z, z, pe, z, 0.1, None, ck, ck, 4)
    with pytest.raises(ValueError, match="rows"):
        nuts_leaf_cuda(z, z, z, pe, z, 0.1, z, ck, ck, None, 2, 4)
    with pytest.raises(ValueError, match="contiguous"):
        nuts_leaf_cuda(z, z, torch.zeros(8, 2, device=dev)[:, 0], pe, z, 0.1,
                       None, ck, ck, 0)
    with pytest.raises(ValueError, match="r_right"):
        nuts_turning_cuda(z, z, z.double(), z)


@pytest.mark.cuda
def test_nuts_batch_kernels_match_plain_on_card():
    """nuts_leaf_batch, nuts_turning_batch and halfstep_chains against
    their plain versions (chip_smoke.nuts_batch_checks) at every C and D of
    the script, float32 and float64, every leaf kind, active and inactive
    chains, both directions: vectors bit-identical, sums within 1e-6 of
    their terms, each active row's vectors bit-identical to a one-chain
    nuts_leaf launch; one launch a call."""
    dev = _need_card()
    ops.reset_launch_counts()
    results, _ = nuts_batch_checks(dev, timed=False)
    cases = len(NUTS_BATCH_CHAINS) * len(NUTS_BATCH_SIZES) * 2
    counts = ops.launch_counts()
    assert counts["nuts_leaf_batch"] == cases * len(NUTS_LEAVES)
    assert counts["nuts_turning_batch"] == counts["halfstep_chains"] == cases
    assert all(r.get("vectors_bit_identical", True)
               and r.get("one_chain_vectors_bit_identical", True)
               and r.get("bit_identical", True) for r in results)


@pytest.mark.cuda
def test_nuts_batch_wrappers_refuse_bad_operands_on_card():
    dev = _need_card()
    z = torch.zeros(3, 8, device=dev)
    ck = torch.zeros(3, 4, 8, device=dev)
    c3 = torch.zeros(3, device=dev)
    on = torch.ones(3, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="active"):
        halfstep_chains_cuda(z, z, z, z, c3, on.float())
    with pytest.raises(ValueError, match="eps"):
        halfstep_chains_cuda(z, z, z, z, c3[:2], on)
    with pytest.raises(ValueError, match="r_ckpts"):
        nuts_leaf_batch_cuda(z, z, z, c3, z, c3, on, None, ck[:, :, :7], ck,
                             0)
    with pytest.raises(ValueError, match="ckpt_i"):
        nuts_leaf_batch_cuda(z, z, z, c3, z, c3, on, None, ck, ck, 4)
    with pytest.raises(ValueError, match="rows"):
        nuts_leaf_batch_cuda(z, z, z, c3, z, c3, on, z, ck, ck, None, 2, 4)
    with pytest.raises(ValueError, match="r_sum"):
        nuts_turning_batch_cuda(z, z, z, z.double())


@pytest.mark.cuda
def test_lockstep_nuts_launches_one_batch_leaf_per_lockstep_leapfrog():
    """MCMC(NUTS, num_chains=3) on the card runs the lockstep tree: one
    nuts_leaf_batch launch a lockstep leapfrog, no one-chain nuts_leaf, and
    the chains' draws finite."""
    import repro_torch.core as pc
    from repro_torch.core import dist
    from repro_torch.core.infer import MCMC, NUTS
    dev = _need_card()

    def model():
        pc.sample("x", dist.Normal(torch.ones(2, device=dev),
                                   2.0 * torch.ones(2, device=dev)))

    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(model), num_warmup=30, num_samples=30, num_chains=3)
    mcmc.run(0)
    counts = ops.launch_counts()
    assert counts["nuts_leaf_batch"] == mcmc.stats["lockstep_leapfrogs"] > 0
    assert counts["nuts_leaf"] == 0
    assert torch.isfinite(mcmc.get_samples()["x"]).all()


@pytest.mark.cuda
def test_lockstep_nuts_resumes_bit_identical_on_card(tmp_path):
    """A lockstep logreg NUTS run on the card killed after the first
    sampling chunk's state write (save #4 of 6) and resumed: the draws, the
    extra fields and the final state bit-identical to the uninterrupted
    run, the resumed part through the lockstep leaf and GLM kernels."""
    from chip_smoke import Preempted, recorded_saves, same_run
    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS
    _need_card()
    data = covtype_data(seed=0, n=4000, d=6)

    def run(**kwargs):
        mcmc = MCMC(NUTS(logreg_model_glm), 24, 36, num_chains=4)
        return mcmc.run(0, data["x"], y=data["y"], **kwargs)

    whole = run()
    ckdir = str(tmp_path / "ck")
    calls, undo = recorded_saves(kill_at=4)
    try:
        with pytest.raises(Preempted):
            run(checkpoint_every=20, checkpoint_dir=ckdir)
    finally:
        undo()
    assert [c["dir"] for c in calls] == ["state", "state",
                                         "samples_000024_000044", "state"]
    ops.reset_launch_counts()
    resumed = run(checkpoint_every=20, checkpoint_dir=ckdir, resume=True)
    counts = ops.launch_counts()
    assert resumed.stats["resumed_at"] == 44
    assert same_run(resumed, whole)
    assert counts["nuts_leaf_batch"] > 0 and counts["glm_potential_grad"] > 0


@pytest.mark.cuda
def test_telemetry_on_card_adds_one_sync_a_chunk_and_moves_no_bit(tmp_path):
    """A 4-chain lockstep logreg NUTS run on the card in chunks of 20 with
    telemetry on against off: the draws, extra fields and final state
    bit-identical, every launch counter equal, and the host syncs at most
    one more a chunk (one more for a chunk that diverged)."""
    from chip_smoke import same_run
    from repro_torch import obs
    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS
    _need_card()
    data = covtype_data(seed=0, n=4000, d=6)
    runs = []
    for tele in (None, obs.Telemetry(dir=str(tmp_path))):
        ops.reset_launch_counts()
        mcmc = MCMC(NUTS(logreg_model_glm), 24, 36, num_chains=4,
                    telemetry=tele)
        mcmc.run(0, data["x"], y=data["y"], checkpoint_every=20)
        runs.append((mcmc, ops.launch_counts(), tele))
    (off, c_off, _), (on, c_on, tele) = runs
    assert same_run(on, off)
    assert c_on == c_off and c_on["nuts_leaf_batch"] > 0
    chunks = len([s for s in tele.spans if s.name.endswith("_chunk")])
    divergent = len({(r["iteration"] - 24) // 20
                     for r in tele.forensics.records})
    assert chunks == 4
    assert on.stats["host_syncs"] - off.stats["host_syncs"] \
        <= chunks + divergent


@pytest.mark.cuda
def test_chees_telemetry_profiles_its_graph_capture_on_card(tmp_path):
    """ChEES with telemetry and ``profile_dir``: its CUDA graphs are
    captured inside the first chunk span, under ``torch.profiler``; the run
    is bit-identical to one without, graphed in both with equal replays,
    one trace a chunk span, only the first ``program_cold``."""
    from chip_smoke import same_run
    from repro_torch import obs
    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import MCMC, ChEES
    _need_card()
    data = covtype_data(seed=0, n=4000, d=6)
    prof = tmp_path / "prof"
    runs = []
    for tele in (None, obs.Telemetry(profile_dir=str(prof))):
        mcmc = MCMC(ChEES(logreg_model_glm), 40, 20, num_chains=8,
                    telemetry=tele)
        runs.append(mcmc.run(0, data["x"], y=data["y"],
                             checkpoint_every=20))
    off, on = runs
    assert same_run(on, off)
    assert on.stats["trajectory_graph"] and off.stats["trajectory_graph"]
    assert on.stats["graph_replays"] == off.stats["graph_replays"]
    tele = on.telemetry
    cold = [s.attr("program_cold") for s in tele.spans
            if s.name.endswith("_chunk")]
    assert cold == [True, False, False]
    assert tele.counters["graph_captures"] == 2
    assert len(list(prof.iterdir())) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mala_accept_kernel_matches_plain_on_card(dtype):
    """mala_accept against its plain version at ENS_SHAPES, MALA
    and RWM, in warmup and after, proposals made as the sampler makes them
    (chip_smoke.accept_operands: one chain's proposal potential inf, one
    NaN): the divergences and accept choices equal, accept_prob within what
    the sums' 1e-6 allows; the selections, the running mean and the
    harmonic mean bit-identical to the plain version's for the kernel's
    accept_prob; repeated calls bit-identical; one launch a call."""
    dev = _need_card()
    ops.reset_launch_counts()
    eps = 0.0071
    coef = float(np.float32(-0.25) / np.float32(eps))
    calls, spread = 0, []
    for seed, (c, d) in enumerate(ENS_SHAPES):
        for algo in ("MALA", "RWM"):
            base, mean = accept_operands(c, d, dtype, seed, dev,
                                                    algo, eps)
            z, pe, grad, z_new, pe_new, grad_new, noise, m, u = base
            tol = accept_prob_tolerance(base, eps, coef)
            for n_post in (0, 7):
                args = base + (eps, coef, mean, n_post)
                got = mala_accept_cuda(*args)
                again = mala_accept_cuda(*args)
                want = mala_accept_ref(*args)
                calls += 2
                torch.cuda.synchronize()
                ap = got[3]
                assert torch.equal(got[4], want[4])
                nan = ap.isnan()
                assert torch.equal(nan, want[3].isnan())
                err = (ap - want[3]).abs().double()[~nan]
                assert bool((err <= tol[~nan] * torch.maximum(
                    ap, want[3]).double()[~nan]).all())
                spread += ap[~nan].tolist()
                # the plain selection from the kernel's accept_prob
                acc = u < ap
                assert torch.equal(acc, u < want[3])
                assert same_bits(got[0], torch.where(acc[:, None], z_new, z))
                assert same_bits(got[1], torch.where(acc, pe_new, pe))
                if algo == "MALA":
                    assert same_bits(got[2], torch.where(
                        acc[:, None], grad_new, grad))
                else:
                    assert got[2] is None
                if n_post:
                    assert same_bits(got[5], mean + (ap - mean) / n_post)
                    assert got[6] is None
                else:
                    assert got[5] is ap
                    assert same_bits(got[6], harmonic_mean_accept(ap))
                for a, b in zip(got, again):
                    if isinstance(a, torch.Tensor) and a.dtype != torch.bool:
                        assert same_bits(a, b)
    assert ops.launch_counts()["mala_accept"] == calls
    # the proposals test the accept step, not only its saturation at 1
    assert 0.05 < float(np.mean(np.array(spread) < 1.0)) < 0.95


@pytest.mark.cuda
def test_mala_accept_wrapper_refuses_bad_operands_on_card():
    dev = _need_card()
    z, c = torch.zeros(4, 6, device=dev), torch.zeros(4, device=dev)
    m = torch.ones(6, device=dev)
    with pytest.raises(TypeError, match="float32/float64"):
        mala_accept_cuda(z.half(), c.half(), None, z.half(), c.half(), None,
                         None, m.half(), c.half(), 0.1, -2.5, c.half(), 0)
    with pytest.raises(ValueError, match="together"):
        mala_accept_cuda(z, c, z, z, c, None, None, m, c, 0.1, -2.5, c, 0)
    with pytest.raises(ValueError, match="pe_new"):
        mala_accept_cuda(z, c, None, z, c[:3], None, None, m, c, 0.1, -2.5,
                         c, 0)
    with pytest.raises(ValueError, match="m_inv"):
        mala_accept_cuda(z, c, None, z, c, None, None, m[:5], c, 0.1, -2.5,
                         c, 0)
    with pytest.raises(ValueError, match="host number"):
        mala_accept_cuda(z, c, None, z, c, None, None, m, c,
                         torch.tensor(0.1, device=dev), -2.5, c, 0)
    with pytest.raises(ValueError, match="chains"):
        big = torch.zeros(5000, 6, device=dev)
        mala_accept_cuda(big, big[:, 0].contiguous(), None, big,
                         big[:, 0].contiguous(), None, None, m,
                         big[:, 0].contiguous(), 0.1, -2.5,
                         big[:, 0].contiguous(), 0)


def test_lm_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(torch.zeros(3, 8), torch.ones(8))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_cuda(q, q, q)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, tol):
    """float32: max-abs within ``tol``; bfloat16: elementwise within one
    bfloat16 rounding step (``ops.BF16_RTOL``)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert float(err.max()) <= tol, float(err.max())
    else:
        bound = ops.BF16_RTOL * want.float().abs() + ops.BF16_ATOL
        assert bool((err <= bound).all()), float((err - bound).max())


# the LM's rows (prefill and decode norms of Qwen3-8B at B = 4, P = 512,
# its q/k-norm rows) and ragged ones
RMSNORM_SHAPES = [(2048, 4096), (4, 1, 4096), (4, 512, 32, 128), (4, 1, 8, 128),
                  (7, 96), (1, 1), (3, 5, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    for i, shape in enumerate(RMSNORM_SHAPES):
        rng = np.random.default_rng(i)
        x = torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(dev)
        w = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1])).float().to(dev)
        _assert_close(rmsnorm_cuda(x, w), rmsnorm_ref(x, w), TOL["rmsnorm"])
    assert ops.launch_counts()["rmsnorm"] == len(RMSNORM_SHAPES)
    with pytest.raises(ValueError, match="weight"):
        rmsnorm_cuda(x, w.to(dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_wide_and_unaligned_rows_on_card(dtype):
    """The forward's other paths: rows wider than a team holds (the
    two-pass kernel, vector and scalar loads) and x starting off 16 bytes
    (scalar loads), against the plain version."""
    dev = _need_card()
    for i, shape in enumerate([(3, 10000), (2, 9001), (5, 20000)]):
        rng = np.random.default_rng(40 + i)
        x = torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(dev)
        w = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1])).float().to(dev)
        _assert_close(rmsnorm_cuda(x, w), rmsnorm_ref(x, w), TOL["rmsnorm"])
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.standard_normal((64, 512))).to(dtype).to(dev)
    x_off = torch.empty(1 + x.numel(), dtype=dtype, device=dev)[1:] \
        .view(64, 512)
    x_off.copy_(x)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 512)).float().to(dev)
    _assert_close(rmsnorm_cuda(x_off, w), rmsnorm_ref(x, w), TOL["rmsnorm"])


# (B, S, H, K, dq, dv, causal): Qwen3-8B's prefill, ragged S, MLA-shaped
# dq != dv, MQA, bidirectional, gemma's head dim, a sequence under a tile
FLASH_SHAPES = [(4, 512, 32, 8, 128, 128, True), (2, 200, 4, 2, 64, 64, True),
                (2, 200, 4, 2, 64, 64, False), (1, 130, 4, 4, 192, 128, True),
                (2, 96, 8, 1, 64, 64, True), (1, 64, 2, 1, 256, 256, True),
                (3, 7, 2, 2, 32, 16, False)]
# bf16 only: S at the edges of the tensor-core kernels' tiles (128 queries
# up to head dim 128, 64 above, and 64 keys; the dkv pass's 64 keys and 32
# queries) at both head-dim buckets, and gemma-2b's sequence
TILE_EDGE_SHAPES = [(1, S, 4, 2, 128, 128, True)
                    for S in (63, 64, 65, 127, 129, 1024)] + \
    [(1, S, 2, 1, 256, 256, False) for S in (63, 64, 65, 127, 129, 1024)]


def _flash_cases(dtype):
    return FLASH_SHAPES + (TILE_EDGE_SHAPES if dtype == torch.bfloat16
                           else [])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    cases = _flash_cases(dtype)
    for i, (B, S, H, K, dq, dv, causal) in enumerate(cases):
        rng = np.random.default_rng(i)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(dtype)
                   .to(dev) for shape in ((B, S, H, dq), (B, S, K, dq),
                                          (B, S, K, dv)))
        o, lse = flash.flash_attention_cuda(q, k, v, causal=causal)
        ro, rlse = flash.flash_attention_ref(q, k, v, causal=causal)
        _assert_close(o, ro, TOL["attention"])
        _assert_close(lse, rlse, TOL["attention"])
    assert ops.launch_counts()["attention"] == len(cases)


@pytest.mark.cuda
def test_reduced_qwen3_prefill_on_card():
    """A reduced float32 Qwen3 prefilled through the kernels against the
    same prefill through the plain versions on the card (1e-4: the kernels'
    float32 bounds carried through four layers), with every norm and
    attention launch counted."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import LM, reduced

    dev = _need_card()
    lm = LM(reduced(get_config("qwen3-8b")))
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        3, lm.cfg.vocab_size, (2, 64))).to(dev)
    prefill = make_prefill_step(lm)
    ops.reset_launch_counts()
    got = prefill(w, {"tokens": toks})
    counts = ops.launch_counts()
    L = lm.cfg.num_layers
    assert counts["rmsnorm"] == 4 * L + 1 and counts["attention"] == L
    saved = dict(ops.SPECS)
    try:
        for name in ("rmsnorm", "attention"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        want = prefill(w, {"tokens": toks})
    finally:
        ops.SPECS.update(saved)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# the training slice: rmsnorm backward, flash-attention dq/dkv, softmax_xent
# ---------------------------------------------------------------------------

def test_train_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_bwd_cuda(x, torch.ones(8), x)
    q = torch.zeros(1, 4, 2, 8)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_dq_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_dkv_cuda(q, q, q, lse, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        xent.softmax_xent_cuda(x, torch.zeros(8, 5),
                               torch.zeros(3, dtype=torch.int32))


def test_softmax_xent_reads_both_weight_layouts_without_a_copy():
    """The kernel's two layouts: a row-major (d, V) unembedding and the
    transpose of a row-major (V, d) embedding; any other strides raise
    rather than copy the weight."""
    w = torch.zeros(4, 6)
    assert xent._layout(w) == 0
    assert xent._layout(torch.zeros(6, 4).T) == 1
    with pytest.raises(ValueError, match="strides"):
        xent._layout(torch.zeros(4, 12)[:, ::2])
    # a size-1 dimension may have any stride, the other one may not: a
    # column slice (d, 1) of a wider matrix is not contiguous memory
    assert xent._layout(torch.zeros(4, 1)) == 0
    assert xent._layout(torch.zeros(1, 4).T) == 0
    assert xent._layout(torch.zeros(4, 12)[1:2]) == 0
    for column in (torch.zeros(4, 12)[:, 3:4], torch.zeros(12, 4)[:, 1:2],
                   torch.zeros(12, 4)[:, 1:2].T):
        with pytest.raises(ValueError, match="strides"):
            xent._layout(column)


@pytest.mark.cuda
def test_train_kernel_wrappers_refuse_bad_operands_on_card():
    dev = _need_card()
    x = torch.zeros(3, 8, device=dev)
    w = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="g is"):
        rmsnorm_bwd_cuda(x, w, torch.zeros(3, 7, device=dev))
    q = torch.zeros(1, 4, 2, 8, device=dev)
    lse = torch.zeros(1, 2, 4, device=dev)
    with pytest.raises(ValueError, match="lse is"):
        flash.flash_attention_dq_cuda(q, q[:, :, :1], q[:, :, :1], q,
                                      lse[:, :, :3], q)
    with pytest.raises(ValueError, match="strides"):
        xent.softmax_xent_cuda(x, torch.zeros(8, 10, device=dev)[:, ::2],
                               torch.zeros(3, dtype=torch.int32, device=dev))
    for bad in (-1, 5):
        labels = torch.tensor([0, bad, 1], dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="labels must lie"):
            xent.softmax_xent_cuda(x, torch.zeros(8, 5, device=dev), labels)
    # a captured call cannot read the labels back: the kernel gives NaN
    w5 = torch.zeros(8, 5, device=dev)
    xent.softmax_xent_cuda(x, w5, torch.zeros(3, dtype=torch.int32,
                                              device=dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ce = xent.softmax_xent_cuda(x, w5, labels)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isnan(ce[1]) and torch.isfinite(ce[[0, 2]]).all()


RMSNORM_BWD_SHAPES = [(2048, 2048), (4, 512, 32, 128), (7, 96), (1, 1),
                      (3, 5, 4097),
                      # d not a multiple of 8 (bf16's vector) or of 4, rows
                      # not a multiple of the partition (128 blocks of 4 or
                      # 8 row teams), rows wider than the registers hold
                      (300, 100), (1000, 2048), (129, 4096), (37, 30),
                      (5, 10000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    for i, shape in enumerate(RMSNORM_BWD_SHAPES):
        rng = np.random.default_rng(i)
        x, g = (torch.from_numpy(rng.standard_normal(shape)).to(dtype).to(dev)
                for _ in range(2))
        w = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1])).float().to(dev)
        dx, dw = rmsnorm_bwd_cuda(x, w, g)
        rdx, rdw = rmsnorm_bwd_ref(x, w, g)
        _assert_close(dx, rdx, TOL["rmsnorm"])
        # dw sums over every row: the bound is relative to its largest entry
        _assert_close(dw, rdw, TOL["rmsnorm"] * max(1.0,
                                                    float(rdw.abs().max())))
    assert ops.launch_counts()["rmsnorm_bwd"] == len(RMSNORM_BWD_SHAPES)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary (the kernels then take scalar loads)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
def test_bf16_backward_kernels_repeat_bitwise_on_card():
    """Two calls of the bf16 dq pass and of ``rmsnorm_bwd_cuda`` on the same
    inputs give the same bits (dw and dq are summed in a fixed order, with
    no atomics), also when the operands are not 16-byte aligned."""
    dev = _need_card()
    rng = np.random.default_rng(11)
    for shape in ((2048, 2048), (1000, 2048), (300, 100), (5, 10000)):
        x, g = (torch.from_numpy(rng.standard_normal(shape)).to(
            torch.bfloat16).to(dev) for _ in range(2))
        w = torch.from_numpy(rng.uniform(0.5, 1.5, shape[-1])).float().to(dev)
        for xs, gs in ((x, g), (_misaligned(x), _misaligned(g))):
            (dx, dw), (dx2, dw2) = (rmsnorm_bwd_cuda(xs, w, gs)
                                    for _ in range(2))
            assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
            _assert_close(dx, rmsnorm_bwd_ref(x, w, g)[0], TOL["rmsnorm"])
    for B, S, H, K, dq, dv, causal in ((2, 1024, 8, 1, 256, 256, True),
                                       (1, 200, 4, 2, 128, 128, False)):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(
            torch.bfloat16).to(dev) for shape in ((B, S, H, dq),
                                                  (B, S, K, dq),
                                                  (B, S, K, dv),
                                                  (B, S, H, dv)))
        o, lse = (t.contiguous() for t in
                  flash.flash_attention_ref(q, k, v, causal=causal))
        first, second = (flash.flash_attention_dq_cuda(q, k, v, o, lse, do,
                                                       causal)
                         for _ in range(2))
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])


# bf16 only: each dq_tc_kernel instantiation (the exact 128/128 and
# 256/256, the guarded buckets up to 128 and 256) at ragged S, causal and
# not, and head dims that are not a multiple of 8 (scalar loads)
DQ_TC_SHAPES = [(1, 200, 4, 4, 128, 128, True), (2, 130, 4, 1, 256, 256, False),
                (1, 130, 4, 2, 192, 128, True), (2, 65, 4, 2, 96, 64, False),
                (1, 70, 2, 1, 36, 20, True), (1, 97, 2, 1, 200, 136, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernels_match_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    cases = _flash_cases(dtype) + [(2, 1024, 8, 1, 256, 256, True)]
    if dtype == torch.bfloat16:
        cases += DQ_TC_SHAPES
    for i, (B, S, H, K, dq, dv, causal) in enumerate(cases):
        rng = np.random.default_rng(i)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(dtype)
                       .to(dev) for shape in ((B, S, H, dq), (B, S, K, dq),
                                              (B, S, K, dv), (B, S, H, dv)))
        o, lse = (t.contiguous() for t in
                  flash.flash_attention_ref(q, k, v, causal=causal))
        dq_, delta = flash.flash_attention_dq_cuda(q, k, v, o, lse, do,
                                                   causal)
        rdq, rdelta = flash.flash_attention_dq_ref(q, k, v, o, lse, do,
                                                   causal)
        rdelta = rdelta.contiguous()
        _assert_close(dq_, rdq, TOL["attention"])
        _assert_close(delta, rdelta, TOL["attention"])
        dk, dv_ = flash.flash_attention_dkv_cuda(q, k, v, lse, rdelta, do,
                                                 causal)
        rdk, rdv = flash.flash_attention_dkv_ref(q, k, v, lse, rdelta, do,
                                                 causal)
        _assert_close(dk, rdk, TOL["attention"])
        _assert_close(dv_, rdv, TOL["attention"])
    counts = ops.launch_counts()
    assert counts["attention_dq"] == counts["attention_dkv"] == len(cases)


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain_on_card():
    """``FlashAttention.apply`` with the kernels, through autograd, at a
    small bf16 MQA shape of head dim 256 against autograd of the plain
    version: o and dv within one bf16 step; dq and dk within 2^-6 of their
    largest entry, because the flash backward's delta is dO . o from the
    bf16 o (as the JAX package's ``_flash_bwd``) where autograd
    differentiates the float32 softmax (the plain passes differ from it by
    up to 0.7 % of the largest entry at these shapes on the CPU)."""
    dev = _need_card()
    rng = np.random.default_rng(7)
    B, S, H, K, d = 2, 130, 4, 1, 256
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(
        torch.bfloat16).to(dev) for shape in ((B, S, H, d), (B, S, K, d),
                                              (B, S, K, d), (B, S, H, d)))
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash.FlashAttention.apply(
        *leaves, True, None, flash.flash_attention_cuda,
        flash.flash_attention_dq_cuda, flash.flash_attention_dkv_cuda)[0]
    got = torch.autograd.grad(o, leaves, do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ro = flash.flash_attention_ref(*plain, causal=True)[0]
    want = torch.autograd.grad(ro, plain, do)
    counts = ops.launch_counts()
    assert counts["attention"] == counts["attention_dq"] \
        == counts["attention_dkv"] == 1
    _assert_close(o.detach(), ro.detach(), TOL["attention"])
    _assert_close(got[2], want[2], TOL["attention"])
    for a, b in zip(got[:2], want[:2]):
        err = float((a.float() - b.float()).abs().max())
        assert err <= 2.0 ** -6 * float(b.float().abs().max()), err


# (T, d, V, tied): gemma-2b's microbatch (a tied (V, d) embedding), a
# Qwen3-shaped (d, V) unembedding with its ragged V, ragged small ones
XENT_SHAPES = [(2048, 2048, 256000, True), (256, 4096, 151936, False),
               (37, 24, 301, False), (130, 64, 1000, True), (1, 8, 3, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_xent_kernel_matches_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    for i, (T, d, V, tied) in enumerate(XENT_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(i)
        x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
        w = (torch.randn((V, d) if tied else (d, V), generator=gen,
                         device=dev) * 0.05).to(dtype)
        w = w.T if tied else w
        labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                               dtype=torch.int32)
        got = xent.softmax_xent_cuda(x, w, labels, 1e-4)
        want = xent.softmax_xent_ref(x, w, labels, 1e-4)
        for a, b in zip(got, want):
            _assert_close(a, b, TOL["softmax_xent"])
    assert ops.launch_counts()["softmax_xent"] == len(XENT_SHAPES)


def _bf16_gate(got, want):
    """got (bf16) within one bf16 step of the float32 ``want``."""
    err = (got.float() - want).abs()
    bound = ops.BF16_RTOL * want.abs() + ops.BF16_ATOL
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
def test_softmax_xent_bf16_backward_matches_plain_on_card():
    """The dlogits kernel and its products against the plain backward's
    float32 result on the same values and lse: dx and dw within one bf16
    step, dw in w's layout; one launch a chunk, also through ``ops`` and
    autograd, and over three chunks (dw summed across them in float32)."""
    dev = _need_card()
    ops.reset_launch_counts()
    cases = [(shape, xent.TC_BWD_CHUNK_ELEMENTS) for shape in XENT_SHAPES]
    cases.append(((130, 64, 1000, True), 50 * 1000))  # 50, 50, 30 rows
    for i, ((T, d, V, tied), chunk) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(i)
        x = torch.randn(T, d, generator=gen, device=dev).bfloat16()
        w = (torch.randn((V, d) if tied else (d, V), generator=gen,
                         device=dev) * 0.05).bfloat16()
        w = w.T if tied else w
        labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                               dtype=torch.int32)
        gce, gzl = (torch.rand(T, generator=gen, device=dev) + 0.5
                    for _ in range(2))
        lse = xent.softmax_xent_ref(x, w, labels, 1e-4)[2]
        dx, dw = xent.softmax_xent_bwd_cuda(x, w, labels, lse, gce, gzl,
                                            1e-4, chunk_elements=chunk)
        rdx, rdw = xent.softmax_xent_bwd(x.float(), w.float(), labels, lse,
                                         gce, gzl, 1e-4)
        assert dx.dtype == dw.dtype == torch.bfloat16
        assert dw.shape == w.shape and (dw.stride() == w.stride()
                                        or 1 in w.shape)
        _bf16_gate(dx, rdx)
        _bf16_gate(dw, rdw)
    assert ops.launch_counts()["softmax_xent_bwd"] == len(XENT_SHAPES) + 3
    x = x.detach().requires_grad_()
    emb = w.T.detach().requires_grad_()
    ce, zl = ops.softmax_xent(x, emb.T, labels, z_loss_weight=1e-4)
    ((ce * gce).sum() + (zl * gzl).sum()).backward()
    assert ops.launch_counts()["softmax_xent_bwd"] == len(XENT_SHAPES) + 4
    rdx, rdw = xent.softmax_xent_bwd(x.detach().float(), w.float(), labels,
                                     lse, gce, gzl, 1e-4)
    _bf16_gate(x.grad, rdx)
    _bf16_gate(emb.grad.T, rdw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_xent_float32_and_cpu_take_the_plain_backward(monkeypatch,
                                                              dtype):
    """Through ``SoftmaxXent``: a float32 loss takes ``softmax_xent_bwd`` on
    every device, whatever backward it is handed; a bf16 loss takes the one
    handed to it, which ``ops`` makes the plain version on the CPU."""
    calls, original = [], xent.softmax_xent_bwd

    def plain(*args, **kwargs):
        calls.append("plain")
        return original(*args, **kwargs)

    def kernel(*args, **kwargs):
        calls.append("kernel")
        return plain(*args, **kwargs)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 8), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 11), dtype=np.float32))
    x, w = x.to(dtype).requires_grad_(), w.to(dtype).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, 11, 6))
    monkeypatch.setattr(xent, "softmax_xent_bwd", plain)
    ce, zl = xent.SoftmaxXent.apply(x, w, labels, 1e-2,
                                    xent.softmax_xent_ref, kernel)
    (ce.sum() + zl.sum()).backward()
    assert calls == (["kernel", "plain"] if dtype == torch.bfloat16
                     else ["plain"])
    # on the CPU, ops routes a bf16 loss to the plain backward too
    calls.clear()
    monkeypatch.setitem(ops.BACKWARD, "softmax_xent_bwd",
                        ops.BACKWARD["softmax_xent_bwd"]._replace(ref=plain))
    ce, zl = ops.softmax_xent(x, w, labels, z_loss_weight=1e-2)
    (ce.sum() + zl.sum()).backward()
    assert calls == ["plain"]
    assert ops.launch_counts()["softmax_xent_bwd"] == 0


# ---------------------------------------------------------------------------
# the Mamba-2 slice: ssd_scan


def _ssd_operands(b, l, h, p, g, n, dtype, dev, seed):
    """Inputs in mamba2's ranges (dt in [1e-3, 0.1], A in [-16, -1]),
    x, B, C in ``dtype``, the rest float32."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    x = (0.5 * randn(b, l, h, p)).to(dtype)
    dt = 1e-3 + (0.1 - 1e-3) * rand(b, l, h)
    A = -(1.0 + 15.0 * rand(h))
    B = (0.3 * randn(b, l, g, n)).to(dtype)
    C = (0.3 * randn(b, l, g, n)).to(dtype)
    D = 0.5 + rand(h)
    h0 = 0.1 * randn(b, h, p, n)
    return x, dt, A, B, C, D, h0


def test_ssd_scan_wrapper_refuses_cpu_tensors_and_ragged_lengths():
    x, dt, A, B, C, D, h0 = _ssd_operands(1, 64, 2, 8, 1, 16, torch.float32,
                                          torch.device("cpu"), 0)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ops.ssd_scan(x, dt, A, B, C, chunk=48)


# (b, l, h, p, g, n, chunk): mamba2-370m's prefill heads at a shorter
# length, two B/C groups, chunks of 64, one chunk shorter than 256, the
# reduced model's widths, p not a multiple of 32
SSD_CASES = [(2, 512, 32, 64, 1, 128, 256), (2, 256, 8, 64, 2, 128, 64),
             (3, 100, 4, 64, 1, 128, 100), (2, 64, 16, 16, 1, 16, 32),
             (1, 96, 4, 40, 2, 24, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_on_card(dtype):
    """y within 1e-4 (float32) or one bfloat16 step, the float32 state
    within 1e-4 of its largest entry, with and without D and h0."""
    dev = _need_card()
    ops.reset_launch_counts()
    launches = 0
    for i, (b, l, h, p, g, n, chunk) in enumerate(SSD_CASES):
        x, dt, A, B, C, D, h0 = _ssd_operands(b, l, h, p, g, n, dtype, dev, i)
        for kw in ({}, {"D": D}, {"D": D, "h0": h0}):
            y, st = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, **kw)
            ry, rst = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk, **kw)
            launches += 1
            _assert_close(y, ry, TOL["ssd_scan"])
            scale = max(1.0, float(rst.abs().max()))
            assert float((st - rst).abs().max()) <= TOL["ssd_scan"] * scale
    assert ops.launch_counts()["ssd_scan"] == launches
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssd.ssd_scan_cuda(x[:, :l - 1], dt[:, :l - 1], A, B[:, :l - 1],
                          C[:, :l - 1], chunk=chunk)


@pytest.mark.cuda
def test_ssd_scan_kernel_reads_projection_slices_in_place_on_card():
    """x, B and C as slices of one wider (b, l, width) tensor, as the mixer
    hands them over: the kernel reads them through their strides and gives
    the contiguous copies' result."""
    dev = _need_card()
    b, l, h, p, n = 2, 128, 4, 16, 32
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = 0.4 * torch.randn((b, l, h * p + 2 * n + 8), generator=gen,
                             device=dev)
    x = wide[..., :h * p].reshape(b, l, h, p)
    B = wide[..., h * p:h * p + n].reshape(b, l, 1, n)
    C = wide[..., h * p + n:h * p + 2 * n].reshape(b, l, 1, n)
    assert not x.is_contiguous()
    _, dt, A, _, _, D, _ = _ssd_operands(b, l, h, p, 1, n, torch.float32,
                                         dev, 1)
    got = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=64, D=D)
    want = ssd.ssd_scan_cuda(x.contiguous(), dt, A, B.contiguous(),
                             C.contiguous(), chunk=64, D=D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ssd_tc_kernel_guarded_paths_on_card():
    """The bf16 tensor-core scan off its exact instantiation: n = 256 and
    n = 200 (the wide guarded instantiation), p = 20 and n = 20 (neither a
    multiple of 8: plain loads, not cp.async), and x, B, C as slices that
    start off 16 bytes (plain loads) giving the bits of their contiguous
    copies (cp.async)."""
    dev = _need_card()
    for i, (b, l, h, p, g, n, chunk) in enumerate(
            [(1, 128, 4, 32, 1, 256, 64), (2, 96, 2, 64, 2, 200, 48),
             (1, 80, 3, 20, 1, 20, 40)]):
        x, dt, A, B, C, D, h0 = _ssd_operands(b, l, h, p, g, n,
                                              torch.bfloat16, dev, 20 + i)
        y, st = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, D=D, h0=h0)
        ry, rst = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk, D=D, h0=h0)
        _assert_close(y, ry, TOL["ssd_scan"])
        scale = max(1.0, float(rst.abs().max()))
        assert float((st - rst).abs().max()) <= TOL["ssd_scan"] * scale
    b, l, h, p, n = 2, 128, 4, 16, 32
    gen = torch.Generator(device=dev).manual_seed(1)
    wide = (0.4 * torch.randn((b, l, 1 + h * p + 2 * n), generator=gen,
                              device=dev)).to(torch.bfloat16)
    x = wide[..., 1:1 + h * p].reshape(b, l, h, p)
    B = wide[..., 1 + h * p:1 + h * p + n].reshape(b, l, 1, n)
    C = wide[..., 1 + h * p + n:].reshape(b, l, 1, n)
    _, dt, A, _, _, D, _ = _ssd_operands(b, l, h, p, 1, n, torch.float32,
                                         dev, 2)
    got = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=64, D=D)
    want = ssd.ssd_scan_cuda(x.contiguous(), dt, A, B.contiguous(),
                             C.contiguous(), chunk=64, D=D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ssd_scan_backward_through_kernel_on_card():
    """``SsdScan`` with the kernel's forward: the forward is the kernel's
    (one launch), and its gradients equal autograd of ``ssd_scan_ref``
    called directly."""
    dev = _need_card()
    args = _ssd_operands(2, 128, 4, 16, 2, 32, torch.float32, dev, 3)
    gy = torch.randn((2, 128, 4, 16), device=dev)
    gs = torch.randn((2, 4, 16, 32), device=dev)

    def grads(scan):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        y, st = scan(*leaves)
        ((y * gy).sum() + (st * gs).sum()).backward()
        return [a.grad for a in leaves]

    ops.reset_launch_counts()
    got = grads(lambda *a: ssd.SsdScan.apply(*a, 64, ssd.ssd_scan_cuda))
    assert ops.launch_counts()["ssd_scan"] == 1
    want = grads(lambda x, dt, A, B, C, D, h0: ssd.ssd_scan_ref(
        x, dt, A, B, C, chunk=64, D=D, h0=h0))
    for a, b in zip(got, want):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= TOL["ssd_scan"] * scale


@pytest.mark.cuda
def test_reduced_mamba2_prefill_on_card():
    """A reduced float32 mamba2 prefilled through the kernels against the
    same prefill through the plain versions on the card, one ``ssd_scan``
    per layer and one ``rmsnorm`` per layer plus the final norm."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import LM, reduced

    dev = _need_card()
    lm = LM(reduced(get_config("mamba2-370m")))
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        3, lm.cfg.vocab_size, (2, 64))).to(dev)
    prefill = make_prefill_step(lm)
    ops.reset_launch_counts()
    got = prefill(w, {"tokens": toks})
    counts = ops.launch_counts()
    L = lm.cfg.num_layers
    assert counts["ssd_scan"] == L and counts["rmsnorm"] == L + 1
    saved = dict(ops.SPECS)
    try:
        for name in ("rmsnorm", "ssd_scan"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        want = prefill(w, {"tokens": toks})
    finally:
        ops.SPECS.update(saved)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_skim_potential_on_card_matches_cpu():
    """SKIM's generic potential and gradient at chip_smoke.py's size (p =
    256, n = 200) on the card against the CPU, float64 within 1e-10 and
    float32 within 1e-4 of the largest magnitude (the card's Cholesky
    factor and triangular solves sum in other orders)."""
    from chip_smoke import SKIM_N, SKIM_P
    from repro_torch.bench.models import skim_data, skim_model
    from repro_torch.core.infer import initialize_model_structure
    from repro_torch.core.infer.hmc_util import value_and_grad
    dev = _need_card()
    data = skim_data(SKIM_P, seed=0, n=SKIM_N)
    z = np.random.default_rng(0).uniform(-2, 2, SKIM_P + 4)
    for dtype, rtol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        out = []
        for device in ("cpu", dev):
            x = torch.from_numpy(data["x"]).to(device, dtype)
            y = torch.from_numpy(data["y"]).to(device, dtype)
            pot = initialize_model_structure(None, skim_model, (x,),
                                             {"y": y})[0]
            pe, grad = value_and_grad(pot)(torch.from_numpy(z).to(device,
                                                                  dtype))
            out.append((pe.double().cpu(), grad.double().cpu()))
        (pe_c, g_c), (pe_g, g_g) = out
        assert abs(float(pe_g - pe_c)) <= rtol * abs(float(pe_c))
        assert float((g_g - g_c).abs().max()) <= rtol * float(g_c.abs().max())


@pytest.mark.cuda
def test_mvn_cholesky_failure_gives_nan_on_card():
    """A covariance that is not positive definite gives a NaN density on
    the card, without raising and without a host read (``cholesky_ex``);
    the positive definite matrix of the same batch stays finite."""
    from repro_torch.core.dist import MultivariateNormal
    dev = _need_card()
    cov = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 2.0], [2.0, 1.0]]],
                       device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        lp = MultivariateNormal(torch.zeros(2, device=dev),
                                covariance_matrix=cov).log_prob(
            torch.ones(2, device=dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    lp = lp.cpu()
    assert bool(torch.isfinite(lp[0])) and bool(torch.isnan(lp[1]))


def test_enum_chain_sample_cuda_refuses_cpu_tensors():
    """The backward sample's wrapper takes no CPU tensor (``ops`` routes
    those to the plain version) and checks its shapes first."""
    from repro_torch.kernels.enum_contract import enum_chain_sample_cuda
    a, m = torch.zeros(3, 4), torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        enum_chain_sample_cuda(a, m, a)
    with pytest.raises(ValueError, match="takes"):
        enum_chain_sample_cuda(a, torch.zeros(3, 4, 4), a)
    assert ops.FUSED["enum_chain_sample"].kernel is enum_chain_sample_cuda


@pytest.mark.cuda
def test_enum_chain_sample_bit_identical_on_card():
    """chip_smoke's cases: T in (1, 2, 120, 600) x K in (2, 3, 8, 33, 64) x
    1 and 16 rows x float32/float64, and planted ties; the draws index for
    index the plain version's, one launch a call."""
    from chip_smoke import chain_sample_checks
    dev = _need_card()
    assert ops.FUSED["enum_chain_sample"].bit_identical
    results, _ = chain_sample_checks(dev)
    assert results and all(r["bit_identical"] and r["launches"] == 1
                           for r in results)


@pytest.mark.cuda
def test_infer_discrete_launches_one_filter_and_one_sample_on_card():
    """An ``infer_discrete`` call of the enumerated HMM: one ``enum_chain``
    and one ``enum_chain_sample`` launch, no one-step ``enum_contract``;
    the states in the support."""
    from chip_smoke import ENUM_K, ENUM_T, ENUM_V
    from repro_torch.bench.models import enum_hmm_data, enum_hmm_model
    from repro_torch.core.handlers import substitute
    from repro_torch.core.infer import infer_discrete
    dev = _need_card()
    data = enum_hmm_data(ENUM_K, seed=0, T=ENUM_T, V=ENUM_V)
    pinned = substitute(enum_hmm_model, data={
        "theta": torch.from_numpy(data["true_theta"]).to(dev),
        "phi": torch.from_numpy(data["true_phi"]).to(dev)})
    ops.reset_launch_counts()
    for seed_ in range(3):
        z = infer_discrete(pinned, seed_)(data)["markov"]
        assert z.device.type == "cuda" and z.shape == (ENUM_T,)
        assert bool(((z >= 0) & (z < ENUM_K)).all())
    counts = ops.launch_counts()
    assert counts["enum_chain"] == counts["enum_chain_sample"] == 3
    assert counts["enum_contract"] == 0


@pytest.mark.cuda
def test_svi_steps_on_card_match_the_cpu():
    """Three SVI steps of the minibatch logistic regression on the card and
    on the CPU from one seed (the draws and minibatches are made on the CPU
    for both) agree within 1e-5 in float32."""
    from repro_torch import optim
    from repro_torch.bench.models import covtype_data, svi_logreg_model
    from repro_torch.core.infer import SVI, AutoNormal, Trace_ELBO
    dev = _need_card()
    data = covtype_data(seed=1, n=4000, d=12)
    out = []
    for device in ("cpu", dev):
        model = svi_logreg_model(4000, 400)
        svi = SVI(model, AutoNormal(model), optim.adam(5e-2), Trace_ELBO(),
                  device=device)
        state, losses = svi.run(0, 3, data["x"], data["y"])
        assert losses.device.type == torch.device(device).type
        out.append(({k: v.cpu() for k, v in state.params.items()},
                    losses.cpu()))
    (p_cpu, l_cpu), (p_card, l_card) = out
    torch.testing.assert_close(l_card, l_cpu, rtol=1e-5, atol=1e-5)
    for name in p_cpu:
        torch.testing.assert_close(p_card[name], p_cpu[name], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_one_rank_lm_mesh_step_on_card():
    """A reduced 2-layer float32 gemma on a one-rank (1, 1) LM mesh on the
    card (``chip_smoke.train_mesh_check``): its loss and gradients through
    the kernels (run in ``local_map``), then one ``make_train_step`` step,
    bit-identical to the unsharded kernel run, with the same launches."""
    from chip_smoke import train_mesh_check
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import LM, reduced
    from repro_torch.optim import tree_leaves, tree_map
    dev = _need_card()
    lm = LM(reduced(get_config("gemma-2b"), num_layers=2), remat="full")
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    batch = SyntheticLMData(lm.cfg.vocab_size, 64, 2,
                            seed=0).batch_at(0, device=dev)
    wg = tree_map(lambda p: p.detach().requires_grad_(), w)
    ops.reset_launch_counts()
    loss, _ = lm.forward(wg, batch)
    grads = torch.autograd.grad(loss, tree_leaves(wg))
    counts = ops.launch_counts()
    assert counts["attention"] > 0 and counts["rmsnorm"] > 0
    out = train_mesh_check(dev, lm, w, batch, loss.detach(), grads, counts)
    assert out["loss_and_grads_bit_identical"]
    assert out["step_params_bit_identical"]


@pytest.mark.cuda
def test_registry_parity_on_card():
    """RPL201-203 clean with every one of the 26 registered kernels
    launched against its plain version (``lint.verify_registry``), each
    kernel's launch counter moved by at least its row's launches."""
    from repro_torch import lint
    dev = _need_card()
    ops.reset_launch_counts()
    result = lint.verify_registry(device=dev)
    assert result.ok and not result.findings, str(result)
    rows = [s for s in list(ops.OP_TABLE) + list(ops.FUSED.values())
            + list(ops.BACKWARD.values()) if s.kernel is not None]
    assert len(rows) == 26
    assert all(result.details[s.name]["launches"] >= 1 for s in rows)
    counts = ops.launch_counts()
    assert all(counts[s.name] >= result.details[s.name]["launches"]
               for s in rows)


@pytest.mark.cuda
def test_planted_kernel_drift_is_rpl203_on_card():
    """A kernel that lands ten times its row's bound away from the plain
    version is an RPL203 finding naming the row."""
    from repro_torch import lint
    dev = _need_card()
    spec = ops.SPECS["leapfrog_halfstep"]

    def drifted(*args):
        z, r = spec.kernel(*args)
        return z + 10 * spec.tol, r

    result = lint.check_parity(spec._replace(kernel=drifted), device=dev)
    assert [(f.code, f.site) for f in result.findings] == [
        ("RPL203", "leapfrog_halfstep")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_absorbed_decode_on_card_matches_the_cpu(dtype):
    """The ref-only op on the card against its CPU result on the same
    inputs: float32 within 1e-5 (cuBLAS sums in another order; TF32 off),
    bfloat16 within one bfloat16 step."""
    dev = _need_card()
    rng = np.random.default_rng(3)
    B, S, H, dn, dr, r, dv = 2, 9, 4, 16, 8, 12, 16
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in ((B, 1, H, dn), (B, 1, H, dr), (B, S, r),
                                 (B, S, dr), (H, dn, r), (H, r, dv))]
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[0, 5:] = False
    mask[1, :2] = False
    scale = (dn + dr) ** -0.5
    cpu = ops.mla_absorbed_decode(*args, mask, scale=scale)
    card = ops.mla_absorbed_decode(*(a.to(dev) for a in args), mask.to(dev),
                                   scale=scale)
    _assert_close(card.cpu(), cpu, 1e-5)
