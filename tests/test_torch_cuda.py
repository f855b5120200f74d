"""The port's CUDA kernel wrappers: what runs without a card (they refuse
CPU tensors, a build without nvcc raises) and, on a card (``-m cuda``),
each kernel against its plain version.  No JAX here, so the file also runs
on a machine that has a card and no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as flash
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
from repro_torch.kernels import softmax_xent as xent
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_cuda, rmsnorm_bwd_ref,
                                         rmsnorm_cuda, rmsnorm_ref)
from repro_torch.kernels.rwm_mala import mala_step_cuda, mala_step_ref
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


# (B, S, H, K, dq, dv, causal): Qwen3-8B's prefill, ragged S, MLA-shaped
# dq != dv, MQA, bidirectional, gemma's head dim, a sequence under a tile
FLASH_SHAPES = [(4, 512, 32, 8, 128, 128, True), (2, 200, 4, 2, 64, 64, True),
                (2, 200, 4, 2, 64, 64, False), (1, 130, 4, 4, 192, 128, True),
                (2, 96, 8, 1, 64, 64, True), (1, 64, 2, 1, 256, 256, True),
                (3, 7, 2, 2, 32, 16, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    for i, (B, S, H, K, dq, dv, causal) in enumerate(FLASH_SHAPES):
        rng = np.random.default_rng(i)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape)).to(dtype)
                   .to(dev) for shape in ((B, S, H, dq), (B, S, K, dq),
                                          (B, S, K, dv)))
        o, lse = flash.flash_attention_cuda(q, k, v, causal=causal)
        ro, rlse = flash.flash_attention_ref(q, k, v, causal=causal)
        _assert_close(o, ro, TOL["attention"])
        _assert_close(lse, rlse, TOL["attention"])
    assert ops.launch_counts()["attention"] == len(FLASH_SHAPES)


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
                      (3, 5, 4097)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernels_match_plain_on_card(dtype):
    dev = _need_card()
    ops.reset_launch_counts()
    cases = FLASH_SHAPES + [(2, 1024, 8, 1, 256, 256, True)]
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
