"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``) and build
   the hand-written kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together).
2. ``samplers``: hold each kernel of slices 1-3 against its plain PyTorch
   version on the card, at the main paths' shapes and at ragged ones, and
   time kernel and plain version with CUDA events (``enum_contract`` also
   against ``torch.logsumexp``, the library yardstick, and at a large
   shape; the batch leapfrog and the MALA/RWM proposal also at (64,
   1,000,003)).  Then drive the main paths through the user's entry points,
   each with every kernel launch counter set to 0 just before and read just
   after: ``MCMC(NUTS(logreg_model_glm), 100, 100).run(...)`` on 581,012 x
   54 CoverType-shaped data made from a seed, then the paper's fixed-step
   configuration (0 warmup, 40 draws, step 0.0015, no adaptation); the
   fully-latent HMM ``MCMC(NUTS(enum_hmm_model, max_tree_depth=8), 50,
   50)`` at K = 8, T = 120, V = 16, whose states ``markov`` sums out
   through the ``enum_contract`` kernel pair; and the paper's
   semi-supervised ``hmm_model`` at T = 600, T_sup = 100, K = 3, V = 10
   (50 warmup + 20 draws); then the ensemble samplers on the same logreg
   data: ``MCMC(ChEES(logreg_model_glm), 300, 1500, num_chains=8)``
   (lockstep trajectories through ``leapfrog_halfstep_batch``),
   ``MCMC(MALA(logreg_model_glm), 500, 500, num_chains=16)`` and ``RWM``
   at the same setting warm-started at MALA's posterior mean (one
   ``mala_step`` launch per iteration, RWM's without the gradient).
3. ``lm``: hold ``rmsnorm`` and ``flash_attention`` against their plain
   versions (float32 and bfloat16, causal and not, MHA/GQA/MQA, dq != dv,
   ragged) and time them beside ``F.rms_norm`` and
   ``F.scaled_dot_product_attention``; then the full Qwen3-8B (bf16,
   params drawn on the card from seed 0): ``make_prefill_step`` at B = 4,
   P = 512 (145 ``rmsnorm`` and 36 ``attention`` launches), and the
   launcher's serving loop (``serve.generate``: the prompt teacher-forced,
   then 32 sampled tokens; 145 ``rmsnorm`` launches and no ``attention``
   per step), its logits at P - 1 against the prefill's; per-token time
   split, device busy share, memory peak; then a full-width 2-layer
   float32 Qwen3 through the kernels against the plain versions: its
   prefill, and 8 decode steps teacher-forced into a fresh cache.
4. ``train``: hold the ``rmsnorm`` backward, the flash-attention dq and
   dkv passes and ``softmax_xent`` against their plain versions (float32
   and bfloat16, causal and not, MHA/GQA/MQA, head dims 128 and 256, dq !=
   dv, a ragged S, T and V, the xent weight as (d, V) and as a tied (V, d)
   embedding's transpose) and time them beside SDPA's backward; then the
   full gemma-2b (bf16, params drawn on the card from seed 0, remat
   "full"): ``make_train_state`` and ``make_train_step`` (the MAP loss with
   the handler-scored log-prior, 2 microbatches, AdamW) for 8 steps on one
   fixed batch of B = 4 x 1024 tokens, the loss falling and 146 ``rmsnorm``,
   74 ``rmsnorm_bwd``, 72 ``attention``, 36 ``attention_dq``, 36
   ``attention_dkv`` and 2 ``softmax_xent`` launches per step; a profiled
   step; ``launch.train.main`` for 2 steps; then a full-width 2-layer
   float32 gemma's loss and every gradient through the kernels against the
   plain versions.
5. ``ssm``: hold ``ssd_scan`` against its plain version (float32 within
   1e-4; bfloat16 ``y`` within one rounding step and the float32 state
   within 1e-4 of its largest entry; with and without ``D``, with ``h0``,
   one and two B/C groups, chunks of 256, 64 and one shorter than 256; a
   ragged length raises), and ``SsdScan``'s kernel forward and its
   gradients against autograd of the plain version; time it at
   mamba2-370m's prefill shape; then the
   full mamba2-370m (bf16, params drawn on the card from seed 0):
   ``make_prefill_step`` at B = 4, P = 2048 (48 ``ssd_scan`` and 49
   ``rmsnorm`` launches), the launcher's serving loop at B = 4, P = 512
   plus 32 sampled tokens (no ``ssd_scan`` and 49 ``rmsnorm`` launches per
   step: decode is the O(1) state update), its logits at P - 1 against a
   prefill's, per-token split, busy share, memory peak; then a full-width
   2-layer float32 mamba2 through the kernels against the plain versions:
   its prefill, 8 decode steps teacher-forced into a fresh cache, and the
   caches.
6. Print one ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
         torch.bfloat16: 989e12}
N, D = 581_012, 54
GLM_REL_TOL = 1e-5
ENUM_K, ENUM_T, ENUM_V = 8, 120, 16
# its draws are cut from 100 + 100 (never K or T) to make room for the
# ensemble phases within the script's time
ENUM_WARMUP, ENUM_DRAWS = 50, 50
HMM_T, HMM_T_SUP, HMM_K, HMM_V = 600, 100, 3, 10
# its draws are cut (never T) to keep the script near 6 minutes: at
# ~150 ms per leapfrog 50 + 50 took 272 s on an H100
HMM_WARMUP, HMM_DRAWS = 50, 20
# enum_contract checks: the main path's shape, the ragged shapes of
# tests/test_kernels.py:268-270, Ki = 1, and the large timing shape
ENUM_MAIN, ENUM_LARGE = ((), ENUM_K, ENUM_K), ((16384,), 64, 64)
ENUM_SHAPES = (ENUM_MAIN, ((), 2, 2), ((), 3, 3), ((), 16, 16),
               ((), 128, 128), ((), 7, 13), ((), 257, 5), ((4,), 8, 8),
               ((2, 3), 5, 5), ((), 1, 6), ENUM_LARGE)
ENUM_BWD_RTOL = 1e-6  # the backward against its plain version
# the ensemble samplers: ChEES at benchmarks/chees.py's 8-chain point
# (300 warmup iterations) with 1500 draws, not 300: on this data its warmup
# leaves a short trajectory (~1.5, ~0.1 effective draws per draw at the
# worst coordinate), and at 300 draws split R-hat exceeds 1.01 for the JAX
# package itself (1.03 in two seeds; PERF.md); MALA and RWM at 16 chains
# (RWM warm-started at MALA's posterior mean)
CHEES_CHAINS, CHEES_WARMUP, CHEES_DRAWS = 8, 300, 1500
MRW_CHAINS, MRW_WARMUP, MRW_DRAWS = 16, 500, 500
RHAT_MAX = 1.01  # tests/test_ensemble.py:144's gate
# batch leapfrog and MALA/RWM checks: the main paths' ensembles, ragged
# ones, and the large timing shape
ENS_CHEES, ENS_MRW, ENS_LARGE = (CHEES_CHAINS, D), (MRW_CHAINS, D), \
    (64, 1_000_003)
ENS_SHAPES = (ENS_CHEES, ENS_MRW, (1, 1), (3, 130), (5, 4097), ENS_LARGE)
# the LM slice: the full Qwen3-8B, B = 4 prompts of 512 tokens (a multiple
# of the JAX prefill's 128-row tiles), 32 sampled tokens
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 512, 32
LM_PREFILL_REPS = 3
# prefill's last logits against the teacher-forced decode logits at P - 1,
# relative rms error: both run the same bf16 model, but the prefill's
# (2048 x d) products and the decode's (4 x d) ones sum in other orders, so
# every bf16-rounded activation may differ by a rounding step (2**-8
# relative); ~10 rounded values per layer over 36 layers compound to a few
# per cent.  A wrong position, mask or cache slot decorrelates the logits
# (relative error ~1).
LM_REL_RMS_MAX = 0.15
# the 2-layer float32 model (its prefill, and LM_F32_DECODE_STEPS decode
# steps) through the kernels against the plain versions: the products are the same cuBLAS calls in both runs, so only the kernels'
# float32 rounding (~1e-7 relative) differs; 1e-4 of the largest logit
LM_F32_REL_TOL = 1e-4
LM_F32_DECODE_STEPS = 8
# rmsnorm checks: the rows of Qwen3-8B's block norms at prefill (timed: the
# main shape first) and decode, its q/k-norm rows, and ragged ones
RMS_TIMED = ((LM_BATCH * LM_PROMPT, 4096), (LM_BATCH * LM_PROMPT * 32, 128),
             (LM_BATCH, 4096))
RMS_SHAPES = RMS_TIMED + ((LM_BATCH * LM_PROMPT * 8, 128), (LM_BATCH * 32, 128),
                          (LM_BATCH * 8, 128), (7, 96), (1, 1), (3, 5, 4097))
# attention checks (B, S, H, K, dq, dv, causal): Qwen3-8B's prefill (timed),
# bidirectional, ragged S with GQA and MHA, MLA-shaped dq != dv, MQA,
# gemma's head dim 256, and a sequence shorter than one tile
ATTN_MAIN = (LM_BATCH, LM_PROMPT, 32, 8, 128, 128, True)
ATTN_SHAPES = (ATTN_MAIN, (LM_BATCH, LM_PROMPT, 32, 8, 128, 128, False),
               (2, 200, 4, 2, 64, 64, True), (2, 200, 4, 4, 64, 64, False),
               (1, 130, 4, 4, 192, 128, True), (2, 96, 8, 1, 64, 64, True),
               (1, 64, 2, 1, 256, 256, True), (3, 7, 2, 2, 32, 16, False))


# the training slice: the full gemma-2b (bf16, remat "full", AdamW), B = 4
# sequences of 1024 tokens in 2 microbatches, 8 steps on one fixed batch (the
# loss must fall as the batch is memorized, as tests/test_archs_smoke.py:61
# asks of the JAX package), then the launcher for 2 steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "gemma-2b", 4, 1024
TRAIN_MICROBATCHES, TRAIN_STEPS, TRAIN_LAUNCHER_STEPS = 2, 8, 2
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
MB_ROWS = TRAIN_BATCH // TRAIN_MICROBATCHES * TRAIN_SEQ  # rows per microbatch
# a full-width 2-layer float32 gemma's loss and every gradient leaf through
# the kernels against the plain versions: 1e-4 of the largest |grad|
TRAIN_F32_LAYERS, TRAIN_F32_REL_TOL = 2, 1e-4
# rmsnorm backward checks: gemma's block-norm rows per microbatch (timed),
# Qwen3's q-norm rows, ragged ones
RMS_BWD_MAIN = (MB_ROWS, 2048)
RMS_BWD_SHAPES = (RMS_BWD_MAIN, (LM_BATCH * LM_PROMPT * 32, 128),
                  (LM_BATCH * LM_PROMPT, 4096), (7, 96), (1, 1), (3, 5, 4097))
# flash-attention backward checks (B, S, H, K, dq, dv, causal): gemma's
# microbatch (MQA, head dim 256; timed), Qwen3's prefill shape (GQA), the
# forward's ragged, bidirectional, MHA, MLA-shaped and tiny cases
ATTN_BWD_MAIN = (TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, 8, 1, 256,
                 256, True)
ATTN_BWD_SHAPES = (ATTN_BWD_MAIN, ATTN_MAIN) + ATTN_SHAPES[1:]
# softmax_xent checks (T, d, V, tied): gemma's microbatch against its tied
# (V, d) embedding (timed), a Qwen3-shaped (d, V) unembedding with its ragged
# V = 151,936, ragged small ones
XENT_MAIN = (MB_ROWS, 2048, 256000, True)
XENT_SHAPES = (XENT_MAIN, (512, 4096, 151936, False), (37, 24, 301, False),
               (130, 64, 1000, True), (1, 8, 3, True))

# the Mamba-2 slice: the full mamba2-370m (bf16, 48 layers), a prefill of
# B = 4 prompts of 2048 tokens (8 chunks of 256), then the launcher's
# serving loop over B = 4 prompts of 512 and 32 sampled tokens
SSM_ARCH, SSM_BATCH, SSM_PREFILL_LEN = "mamba2-370m", 4, 2048
SSM_PROMPT, SSM_TOKENS, SSM_PREFILL_REPS = 512, 32, 3
# the 2-layer float32 mamba2 through the kernels against the plain versions:
# its prefill, then SSM_F32_DECODE_STEPS decode steps and their caches
SSM_F32_LAYERS, SSM_F32_DECODE_STEPS, SSM_F32_REL_TOL = 2, 8, 1e-4
# ssd_scan checks (b, l, h, p, g, n, chunk): mamba2-370m's prefill (timed),
# two B/C groups at chunks of 64, one chunk shorter than 256 (l == chunk),
# the reduced model's widths, p not a multiple of the kernel's 32 channels
SSD_MAIN = (SSM_BATCH, SSM_PREFILL_LEN, 32, 64, 1, 128, 256)
SSD_SHAPES = (SSD_MAIN, (2, 512, 32, 64, 2, 128, 64),
              (2, 200, 8, 64, 1, 128, 200), (2, 64, 16, 16, 1, 16, 32),
              (1, 96, 4, 40, 2, 24, 32))
SSD_BWD_SHAPE = (2, 128, 4, 16, 2, 32, 64)  # the SsdScan backward, float32
# the rmsnorm checks also cover mamba2-370m's block-norm rows at its prefill
# and at a decode step
RMS_SHAPES += ((SSM_BATCH * SSM_PREFILL_LEN, 1024), (SSM_BATCH, 1024))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def call_ms(fn, iters):
    """Time per call of ``fn`` called eagerly from Python (CUDA events): the
    host's enqueue cost is in it whenever it exceeds the device's work."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, reps=5):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so no host cost is
    in the reading."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _replay_ms(graph, iters, reps)


def backward_device_ms(forward, inputs, grad, iters, reps=5):
    """Device time per backward of ``forward(*inputs)`` (leaves that require
    grad) for the output gradient ``grad``: the forward runs once on a side
    stream, so autograd runs its backward on that stream too; ``iters``
    ``torch.autograd.grad`` calls of that one output are then captured in
    one CUDA graph on the same stream and replayed as in :func:`device_ms`,
    so no host cost is in the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*inputs)

    def backward():
        return torch.autograd.grad(out, inputs, grad, retain_graph=True)

    with torch.cuda.stream(side):
        backward()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            backward()
    torch.cuda.current_stream().wait_stream(side)
    return _replay_ms(graph, iters, reps)


def _replay_ms(graph, iters, reps):
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def timings(kernel, plain, iters):
    return {"ms": device_ms(kernel, iters), "plain_ms": device_ms(plain, iters),
            "call_ms": call_ms(kernel, 10 * iters),
            "plain_call_ms": call_ms(plain, 10 * iters)}


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def leapfrog_checks(dev):
    from repro_torch.kernels.leapfrog import (leapfrog_halfstep_cuda,
                                              leapfrog_halfstep_ref)
    tol = 1e-6  # OP_TABLE's bound: one rounding of the same arithmetic
    results, timing = [], None
    for size, dtype in ((D, torch.float32), (1_000_003, torch.float32),
                        (1_000_003, torch.float64)):
        gen = torch.Generator().manual_seed(size)
        z, r, g = (torch.randn(size, generator=gen, dtype=dtype).to(dev)
                   for _ in range(3))
        m_inv = (torch.rand(size, generator=gen, dtype=dtype) + 0.5).to(dev)
        eps = torch.tensor(-0.0123, dtype=dtype, device=dev)
        got = leapfrog_halfstep_cuda(z, r, g, m_inv, eps)
        want = leapfrog_halfstep_ref(z, r, g, m_inv, eps)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        results.append({"D": size, "dtype": str(dtype), "max_abs_err": err,
                        "tol": tol})
        check(err <= tol, f"leapfrog kernel disagrees at D={size} {dtype}: "
                          f"{err} > {tol}")
        if size == D:  # the main path's shape
            itemsize = torch.tensor([], dtype=dtype).element_size()
            timing = (timings(
                lambda: leapfrog_halfstep_cuda(z, r, g, m_inv, eps),
                lambda: leapfrog_halfstep_ref(z, r, g, m_inv, eps), 200),
                bound((6 * size + 1) * itemsize, 5 * size, dtype), err)
    return results, timing


def glm_checks(dev):
    from repro_torch.kernels.glm_potential import (glm_potential_grad_cuda,
                                                   glm_potential_grad_ref)
    results, timing = [], None
    for n, d in ((N, D), (1001, 7)):
        for family, scale in (("bernoulli_logit", None), ("normal", 0.7)):
            gen = torch.Generator().manual_seed(n + d)
            x = torch.randn((n, d), generator=gen).to(dev)
            w = (0.3 * torch.randn(d, generator=gen)).to(dev)
            off = (0.2 * torch.randn(n, generator=gen)).to(dev)
            if family == "bernoulli_logit":
                y = (torch.rand(n, generator=gen) < 0.5).float().to(dev)
            else:
                y = x @ w + 0.5 * torch.randn(n, generator=gen).to(dev)
            kv, kg = glm_potential_grad_cuda(x, y, w, off, scale, family)
            # the referee: the same formula in float64
            pv, pg = glm_potential_grad_ref(x, y, w.double(), off, scale,
                                            family,
                                            compute_dtype=torch.float64)
            # float32 sums over n rows in another order: the error scales
            # with the sum of the magnitudes of the summed terms
            xd, wd = x.double(), w.double()
            logits = xd @ wd + off.double()
            if family == "bernoulli_logit":
                resid = torch.sigmoid(logits) - y.double()
                terms = torch.nn.functional.softplus(logits) \
                    - y.double() * logits
            else:
                resid = (logits - y.double()) / scale ** 2
                terms = 0.5 * ((logits - y.double()) / scale) ** 2 \
                    + math.log(scale)
            g_scale = (resid.abs()[:, None] * xd.abs()).sum(0)
            tol_v = 5e-3 + GLM_REL_TOL * float(terms.abs().sum())
            tol_g = 5e-3 + GLM_REL_TOL * g_scale
            err_v = abs(float(kv) - float(pv))
            err_g = (kg.double() - pg).abs()
            ok = err_v <= tol_v and bool((err_g <= tol_g).all())
            results.append({"n": n, "d": d, "family": family,
                            "max_abs_err": max(err_v, float(err_g.max())),
                            "tol": "5e-3 + 1e-5 * sum|terms| (float32 "
                                   "summation order)",
                            "nll_err": err_v, "nll_tol": tol_v})
            check(ok, f"GLM kernel disagrees at n={n} d={d} {family}: "
                      f"nll err {err_v} (tol {tol_v}), grad err "
                      f"{float(err_g.max())}")
            kv2, kg2 = glm_potential_grad_cuda(x, y, w, off, scale, family)
            check(torch.equal(kv, kv2) and torch.equal(kg, kg2),
                  "GLM kernel is not bit-identical across repeated calls")
            if (n, d, family) == (N, D, "bernoulli_logit"):
                nbytes = 4 * (n * d + 2 * n + 2 * d + 1)
                timing = (timings(
                    lambda: glm_potential_grad_cuda(x, y, w, off, scale,
                                                    family),
                    lambda: glm_potential_grad_ref(x, y, w, off, scale,
                                                   family), 20),
                    bound(nbytes, n * (4 * d + 12), torch.float32),
                    max(err_v, float(err_g.max())))
    return results, timing


def _enum_inputs(batch, ki, k, dtype, seed, dev, masked=False):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(batch + (ki,), generator=gen, dtype=dtype)
    m = torch.randn(batch + (ki, k), generator=gen, dtype=dtype)
    if masked:  # a -inf row and a -inf column (tests/test_kernels.py:284)
        a[1] = -math.inf
        m[:, 2] = -math.inf
    g = torch.randn(batch + (k,), generator=gen, dtype=dtype)
    return a.to(dev), m.to(dev), g.to(dev)


def enum_checks(dev):
    """The forward kernel bit-identical to its plain version, the backward
    within 1e-6 relative, on every shape in float32 and float64; timings
    at the main shape and the large one."""
    from repro_torch.kernels.enum_contract import (enum_contract_bwd_cuda,
                                                   enum_contract_bwd_ref,
                                                   enum_contract_cuda,
                                                   enum_contract_ref)
    cases = [(shape, False) for shape in ENUM_SHAPES] + [(((), 3, 4), True)]
    results, timing = [], {}
    for dtype in (torch.float32, torch.float64):
        for seed, ((batch, ki, k), masked) in enumerate(cases):
            a, m, g = _enum_inputs(batch, ki, k, dtype, seed, dev, masked)
            out = enum_contract_cuda(a, m)
            want = enum_contract_ref(a, m)
            da, dm = enum_contract_bwd_cuda(a, m, out, g)
            ra, rm = enum_contract_bwd_ref(a, m, out, g)
            torch.cuda.synchronize()
            identical = torch.equal(out, want)
            finite = torch.isfinite(want)
            fwd_err = 0.0 if identical else float(
                torch.where(finite, (out - want).abs(),
                            (out != want).to(dtype) * math.inf).max())
            bwd_err = max(float(((x - y).abs() / (1.0 + y.abs())).max())
                          for x, y in ((da, ra), (dm, rm)))
            bwd_abs = max(float((x - y).abs().max())
                          for x, y in ((da, ra), (dm, rm)))
            nan = bool(torch.isnan(da).any() or torch.isnan(dm).any())
            results.append({"batch": batch, "Ki": ki, "K": k,
                            "masked": masked, "dtype": str(dtype),
                            "fwd_bit_identical": identical,
                            "max_abs_err": fwd_err,
                            "bwd_max_rel_err": bwd_err,
                            "bwd_max_abs_err": bwd_abs, "bwd_nan": nan})
            check(identical, f"enum_contract kernel is not bit-identical to "
                             f"its plain version at {batch} x ({ki}, {k}) "
                             f"{dtype}: max error {fwd_err}")
            check(bwd_err <= ENUM_BWD_RTOL and not nan,
                  f"enum_contract_bwd disagrees at {batch} x ({ki}, {k}) "
                  f"{dtype}: {bwd_err} > {ENUM_BWD_RTOL} or NaN ({nan})")
            if masked:
                check(bool(torch.isneginf(out[2])) and float(da[1]) == 0.0
                      and float(dm[1].abs().max()) == 0.0
                      and float(dm[:, 2].abs().max()) == 0.0,
                      "enum_contract: the masked row/column is not -inf with "
                      "zero gradients")
            if dtype == torch.float32 and not masked \
                    and (batch, ki, k) in (ENUM_MAIN, ENUM_LARGE):
                timing[(batch, ki, k)] = enum_timing(a, m, g, out)
    return results, timing


def enum_timing(a, m, g, out):
    from repro_torch.kernels.enum_contract import (enum_contract_bwd_cuda,
                                                   enum_contract_bwd_ref,
                                                   enum_contract_cuda,
                                                   enum_contract_ref)
    rows, ki, k = max(1, math.prod(a.shape[:-1])), a.shape[-1], m.shape[-1]
    iters = 200 if rows == 1 else 20
    fwd = timings(lambda: enum_contract_cuda(a, m),
                  lambda: enum_contract_ref(a, m), iters)
    fwd["library_ms"] = device_ms(
        lambda: torch.logsumexp(a[..., :, None] + m, dim=-2), iters)
    bwd = timings(lambda: enum_contract_bwd_cuda(a, m, out, g),
                  lambda: enum_contract_bwd_ref(a, m, out, g), iters)
    bwd["library_ms"] = None  # no single PyTorch call computes it
    cells = rows * ki * k
    fwd_bound = bound(4 * (rows * ki + cells + rows * k),
                      5 * cells + rows * k, torch.float32)
    bwd_bound = bound(4 * (2 * rows * ki + 2 * cells + 2 * rows * k),
                      5 * cells, torch.float32)
    return {"shape": [list(a.shape), list(m.shape)],
            "enum_contract": (fwd, fwd_bound),
            "enum_contract_bwd": (bwd, bwd_bound)}


def ensemble_kernel_checks(dev):
    """The batch leapfrog (kick 0.5 and 1.0) and the MALA proposal (with
    and without grad) against their plain versions on every shape of
    ``ENS_SHAPES`` in float32 and float64, within OP_TABLE's 1e-6 (both
    kernels round every operation as the plain version does, so the error
    is expected to be 0); timings at the main shapes and the large one."""
    from repro_torch.kernels.leapfrog import (leapfrog_halfstep_batch_cuda,
                                              leapfrog_halfstep_batch_ref)
    from repro_torch.kernels.ops import SPECS
    from repro_torch.kernels.rwm_mala import mala_step_cuda, mala_step_ref
    results, timing = [], {}
    eps = 0.0123
    for dtype in (torch.float32, torch.float64):
        for seed, (c, d) in enumerate(ENS_SHAPES):
            gen = torch.Generator().manual_seed(seed)
            z, r, g, noise = (torch.randn((c, d), generator=gen,
                                          dtype=dtype).to(dev)
                              for _ in range(4))
            m_inv = (torch.rand(d, generator=gen, dtype=dtype) + 0.5).to(dev)
            cases = [("leapfrog_halfstep_batch", f"kick={kick}",
                      lambda k=kick: leapfrog_halfstep_batch_cuda(
                          z, r, g, m_inv, eps, k),
                      lambda k=kick: leapfrog_halfstep_batch_ref(
                          z, r, g, m_inv, eps, k))
                     for kick in (0.5, 1.0)]
            cases += [("mala_step", variant,
                       lambda gr=grad: (mala_step_cuda(z, gr, noise, m_inv,
                                                       eps),),
                       lambda gr=grad: (mala_step_ref(z, gr, noise, m_inv,
                                                      eps),))
                      for variant, grad in (("MALA", g), ("RWM", None))]
            for name, variant, kernel, plain in cases:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in
                          zip(got, want))
                identical = all(torch.equal(a, b) for a, b in zip(got, want))
                tol = SPECS[name].tol
                results.append({"name": name, "variant": variant,
                                "shape": [c, d], "dtype": str(dtype),
                                "max_abs_err": err, "tol": tol,
                                "bit_identical": identical})
                check(err <= tol, f"{name} ({variant}) disagrees at "
                                  f"{(c, d)} {dtype}: {err} > {tol}")
                main = {"leapfrog_halfstep_batch": ENS_CHEES,
                        "mala_step": ENS_MRW}[name]
                if dtype == torch.float32 and (c, d) in (main, ENS_LARGE) \
                        and variant != "kick=0.5":
                    iters = 200 if (c, d) == main else 10
                    timing[(name, variant, (c, d))] = (
                        timings(kernel, plain, iters),
                        ensemble_bound(name, variant, c, d), err)
    return results, timing


def ensemble_bound(name, variant, c, d):
    """Bytes (each (C, D) input read once, each output written once, plus
    the m_inv row) and operations of one call, float32."""
    cells = c * d
    if name == "leapfrog_halfstep_batch":   # z, r, g in; z', r' out
        return bound(4 * (5 * cells + d), 5 * cells, torch.float32)
    if variant == "MALA":                   # z, g, noise in; z' out
        return bound(4 * (4 * cells + d), 4 * cells + 3 * d, torch.float32)
    return bound(4 * (3 * cells + d), 2 * cells + 2 * d, torch.float32)


def profile_transitions(mcmc, num):
    """Device busy share and device time per leapfrog over ``num`` more
    sampling transitions of the adapted chain (or ensemble: there a
    "leapfrog" moves every chain, and a MALA/RWM proposal counts as one),
    under ``torch.profiler``.  The profiler adds host cost, so its wall
    time is not the run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.infer import GeneratorDraws, sample

    setup, state = mcmc.kernel_setup, mcmc.last_state[0]
    draws = GeneratorDraws(torch.Generator().manual_seed(7))
    state = sample(setup, state, draws)
    torch.cuda.synchronize()
    leapfrogs = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(num):
            state = sample(setup, state, draws)
            leapfrogs += getattr(state, "num_steps", 1)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(getattr(a, "self_device_time_total", 0.0), a.count, a.key)
            for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        return {"device_busy_share": None,
                "note": "the profiler recorded no device time"}
    top = sorted(rows, reverse=True)[:8]
    return {
        "transitions": num, "leapfrogs": leapfrogs,
        "wall_ms_per_leapfrog_profiled": wall_us / 1e3 / leapfrogs,
        "device_busy_ms_per_leapfrog": busy_us / 1e3 / leapfrogs,
        "device_busy_share": busy_us / wall_us,
        "device_kernels_per_leapfrog": sum(r[1] for r in rows) / leapfrogs,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_leapfrog": t / 1e3 / leapfrogs,
             "launches_per_leapfrog": c / leapfrogs} for t, c, k in top]}


def run_main_path(dev, data, data_s):
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    out = {}
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(logreg_model_glm), num_warmup=100, num_samples=100)
    mcmc.run(0, data["x"], y=data["y"])
    counts = ops.launch_counts()
    samples = mcmc.get_samples(group_by_chain=True)["w"]
    extra = mcmc.get_extra_fields()
    stats = mcmc.stats
    w = samples.detach().cpu().numpy()
    check(w.shape == (1, 100, D) and np.all(np.isfinite(w)),
          f"samples have shape {w.shape} or are not finite")
    post_err = float(np.max(np.abs(w.mean((0, 1)) - data["true_w"])))
    divergences = int(extra["diverging"].sum())
    out["adaptive"] = {
        "num_warmup": 100, "num_samples": 100, "data_seconds": data_s,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"],
        "num_leapfrog": stats["num_leapfrog"],
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / stats["num_leapfrog"],
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_leapfrog": stats["host_syncs"] / stats["num_leapfrog"],
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "mean_num_steps": float(extra["num_steps"].float().mean()),
        "step_size": float(extra["step_size"][-1]),
        "divergences": divergences,
        "max_abs_posterior_mean_minus_true_w": post_err,
        "min_ess": float(np.min(effective_sample_size(w))),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "glm_prior": stats["glm_prior"],
    }
    print("adaptive NUTS:", json.dumps(out["adaptive"]), flush=True)
    mcmc.print_summary()
    check(divergences == 0, f"{divergences} divergent transitions")
    check(post_err < 0.05, f"posterior mean is {post_err} from true_w")
    check(stats["glm_prior"] == "slim", f"the fused potential's prior term "
          f"runs on the {stats['glm_prior']} data, not on 0 rows")
    for name in ("leapfrog_halfstep", "glm_potential_grad"):
        launches = counts[name]
        check(launches >= stats["num_leapfrog"],
              f"{name}: {launches} launches < {stats['num_leapfrog']} "
              "leapfrogs: the main path did not run through its kernel")

    out["profile"] = profile_transitions(mcmc, 20)
    print("profile:", json.dumps(out["profile"]), flush=True)

    # the paper's fixed-step configuration (benchmarks/logreg.py:27-29)
    ops.reset_launch_counts()
    fixed = MCMC(NUTS(logreg_model_glm, step_size=0.0015,
                      adapt_step_size=False, adapt_mass_matrix=False),
                 num_warmup=0, num_samples=40)
    fixed.run(1, data["x"], y=data["y"])
    fstats = fixed.stats
    out["fixed_step"] = {
        "num_samples": 40, "step_size": 0.0015,
        "num_leapfrog": fstats["num_leapfrog"],
        "chain_seconds": fstats["chain_seconds"],
        "ms_per_leapfrog": 1e3 * fstats["chain_seconds"]
        / fstats["num_leapfrog"],
        "host_syncs_per_leapfrog": fstats["host_syncs"]
        / fstats["num_leapfrog"],
        "launches": ops.launch_counts(),
        "divergences": int(fixed.get_extra_fields()["diverging"].sum()),
    }
    print("fixed-step NUTS:", json.dumps(out["fixed_step"]), flush=True)
    fw = fixed.get_samples()["w"]
    check(bool(torch.isfinite(fw).all()), "fixed-step samples not finite")
    return out, counts


def _simplex_ok(x):
    return bool(torch.isfinite(x).all() and (x >= 0).all()
                and ((x.sum(-1) - 1.0).abs() <= 1e-5).all())


def run_enum_hmm(dev):
    """The fully-latent HMM through the user's entry points: NUTS moves the
    K x K transition and K x V emission rows, ``markov`` sums the hidden
    states out at every gradient through the enum_contract kernel pair."""
    from repro_torch.bench.models import enum_hmm_data, enum_hmm_model
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    data = enum_hmm_data(ENUM_K, seed=0, T=ENUM_T, V=ENUM_V)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(enum_hmm_model, max_tree_depth=8),
                num_warmup=ENUM_WARMUP, num_samples=ENUM_DRAWS)
    mcmc.run(0, data)
    counts = ops.launch_counts()
    stats = mcmc.stats
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    lf, evals = stats["num_leapfrog"], stats["num_grad_evals"]
    theta, phi = samples["theta"], samples["phi"]
    flat = np.concatenate([v.detach().cpu().numpy().reshape(1, ENUM_DRAWS, -1)
                           for v in (theta, phi)], axis=-1)
    out = {
        "K": ENUM_K, "T": ENUM_T, "V": ENUM_V, "num_warmup": ENUM_WARMUP,
        "num_samples": ENUM_DRAWS, "max_tree_depth": 8,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"],
        "num_leapfrog": lf, "num_grad_evals": evals,
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / lf,
        "ms_per_grad_eval": 1e3 * stats["chain_seconds"] / evals,
        "host_syncs_per_leapfrog": stats["host_syncs"] / lf,
        "launches": counts,
        "kernel_launches_per_leapfrog": {
            name: counts[name] / lf for name in
            ("enum_contract", "enum_contract_bwd", "leapfrog_halfstep")},
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "mean_num_steps": float(extra["num_steps"].float().mean()),
        "divergences": int(extra["diverging"].sum()),
        "min_ess": float(np.min(effective_sample_size(flat))),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    print("enumerated HMM NUTS:", json.dumps(out), flush=True)
    check(tuple(theta.shape) == (1, ENUM_DRAWS, ENUM_K, ENUM_K)
          and tuple(phi.shape) == (1, ENUM_DRAWS, ENUM_K, ENUM_V),
          f"samples have shapes {tuple(theta.shape)} {tuple(phi.shape)}")
    check(_simplex_ok(theta) and _simplex_ok(phi),
          "a theta/phi row is off the simplex or not finite")
    check(bool(torch.isfinite(extra["accept_prob"]).all()),
          "an accept_prob is not finite")
    steps = ENUM_T - 1
    for name in ("enum_contract", "enum_contract_bwd"):
        check(counts[name] == steps * evals,
              f"{name}: {counts[name]} launches != (T-1) x {evals} gradient "
              "evaluations: the potential did not run through its kernel")
        check(counts[name] >= steps * lf,
              f"{name}: {counts[name]} launches < (T-1) x {lf} leapfrogs")
    check(counts["leapfrog_halfstep"] >= lf,
          f"leapfrog_halfstep: {counts['leapfrog_halfstep']} launches < "
          f"{lf} leapfrogs")
    out["profile"] = profile_transitions(mcmc, 3)
    print("enumerated HMM profile:", json.dumps(out["profile"]), flush=True)
    out["breakdown"] = enum_potential_breakdown(dev)
    print("enumerated HMM gradient breakdown:", json.dumps(out["breakdown"]),
          flush=True)
    return out, counts


def enum_potential_breakdown(dev, evals=10):
    """Wall ms per value-and-gradient of the enumerated HMM's potential at
    T = 1 (the model, no chain), T = 2 (plus the ``torch.func.vmap``
    transition and one contraction) and the main path's T; the differences
    split a gradient into model, vectorized transition and contraction
    chain."""
    from repro_torch.bench.models import enum_hmm_data, enum_hmm_model
    from repro_torch.core.infer import initialize_model_structure
    from repro_torch.core.infer.hmc_util import value_and_grad

    ms = {}
    for T in (1, 2, ENUM_T):
        data = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v for k, v in enum_hmm_data(ENUM_K, seed=0, T=T,
                                                 V=ENUM_V).items()}
        pot, _, _, _, _, proto = initialize_model_structure(
            torch.Generator().manual_seed(0), enum_hmm_model, (data,))
        pe_and_grad = value_and_grad(pot)
        z = torch.zeros_like(proto).to(dev)
        pe_and_grad(z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(evals):
            pe_and_grad(z)
        torch.cuda.synchronize()
        ms[T] = 1e3 * (time.perf_counter() - t0) / evals
    per_step = (ms[ENUM_T] - ms[2]) / (ENUM_T - 2)
    return {"ms_per_grad_eval": {str(t): v for t, v in ms.items()},
            "model_ms": ms[1],
            "vmap_transition_ms": ms[2] - ms[1] - per_step,
            "contraction_ms_per_step": per_step,
            "contraction_chain_ms": per_step * (ENUM_T - 1)}


def hmm_theta_gate(theta_draws, true_theta, z_max=4.0):
    """Posterior check of the semi-supervised HMM: every entry of the
    posterior mean of ``theta`` lies within ``z_max`` posterior standard
    deviations of the data-generating ``theta``.  (A fixed distance is no
    check here: about 33 supervised transitions per row leave a posterior
    sd near 0.09 per entry, and the reference's own posterior mean lies
    0.1-0.2 from the truth; tests/test_torch_hmm_gate.py runs the reference
    through this gate.)  ``theta_draws`` is ``(..., K, K)``; returns ``(ok,
    max |mean - true|, max z)``."""
    flat = np.asarray(theta_draws).reshape((-1,) + np.shape(true_theta))
    mean, sd = flat.mean(0), np.maximum(flat.std(0, ddof=1), 1e-3)
    dist = np.abs(mean - true_theta)
    z = float(np.max(dist / sd))
    return z <= z_max, float(np.max(dist)), z


def run_hmm(dev):
    """The paper's semi-supervised HMM: a hand-written forward pass (a
    plain PyTorch loop of logsumexp steps, as the JAX model's lax.scan is
    plain jnp) under NUTS."""
    from repro_torch.bench.models import hmm_data, hmm_model
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    data = hmm_data(seed=0, T=HMM_T, T_sup=HMM_T_SUP, K=HMM_K, V=HMM_V)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(hmm_model), num_warmup=HMM_WARMUP,
                num_samples=HMM_DRAWS)
    mcmc.run(0, data)
    counts = ops.launch_counts()
    stats = mcmc.stats
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    lf = stats["num_leapfrog"]
    theta, phi = samples["theta"], samples["phi"]
    th = theta.detach().cpu().numpy()
    ok, err, z = hmm_theta_gate(th, data["true_theta"])
    out = {
        "T": HMM_T, "T_sup": HMM_T_SUP, "K": HMM_K, "V": HMM_V,
        "num_warmup": HMM_WARMUP, "num_samples": HMM_DRAWS,
        "chain_seconds": stats["chain_seconds"], "num_leapfrog": lf,
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / lf,
        "host_syncs_per_leapfrog": stats["host_syncs"] / lf,
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "divergences": int(extra["diverging"].sum()),
        "max_abs_posterior_mean_theta_minus_true": err,
        "max_z_posterior_mean_theta_minus_true": z,
        "min_ess_theta": float(np.min(effective_sample_size(th))),
    }
    print("semi-supervised HMM NUTS:", json.dumps(out), flush=True)
    check(_simplex_ok(theta) and _simplex_ok(phi),
          "a theta/phi row is off the simplex or not finite")
    check(bool(torch.isfinite(extra["accept_prob"]).all()),
          "an accept_prob is not finite")
    check(ok, f"posterior mean of theta is {z} posterior sds ({err}) from "
              "the data-generating theta")
    check(counts["leapfrog_halfstep"] >= lf,
          f"leapfrog_halfstep: {counts['leapfrog_halfstep']} launches < "
          f"{lf} leapfrogs")
    return out


def _ensemble_summary(mcmc, data, counts, extra_keys=()):
    """What an ensemble phase measured, and the gates every phase shares:
    finite draws of the expected shape, no divergence after warmup, the
    posterior mean within 0.05 of ``true_w``, and every GLM launch
    accounted for: one per chain and ensemble evaluation, one per
    evaluation of the initial-point and step-size searches, and the fused
    potential's closing check at setup (``core/infer/glm.py``)."""
    from repro_torch.core.infer import effective_sample_size, gelman_rubin
    stats = mcmc.stats
    chains = mcmc.num_chains
    w = mcmc.get_samples(group_by_chain=True)["w"].detach().cpu().numpy()
    extra = mcmc.get_extra_fields(group_by_chain=True)
    post_err = float(np.max(np.abs(w.mean((0, 1)) - data["true_w"])))
    divergences = int(extra["diverging"].sum())
    evals = stats["num_grad_evals"]
    out = {
        "num_chains": chains, "num_warmup": mcmc.num_warmup,
        "num_samples": mcmc.num_samples,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"],
        "num_iterations": stats["num_iterations"],
        "num_leapfrog": stats["num_leapfrog"],
        "num_grad_evals": evals, "init_grad_evals": stats["init_grad_evals"],
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"]
        / stats["num_leapfrog"],
        "ms_per_iteration": 1e3 * stats["chain_seconds"]
        / stats["num_iterations"],
        "ms_per_grad_eval": 1e3 * stats["chain_seconds"] / evals,
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_iteration": stats["host_syncs"]
        / stats["num_iterations"],
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "step_size": float(extra["step_size"][0, -1]),
        "divergences": divergences,
        "max_abs_posterior_mean_minus_true_w": post_err,
        "max_split_rhat": float(np.max(gelman_rubin(w))),
        "min_ess": float(np.min(effective_sample_size(w))),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "glm_prior": stats["glm_prior"],
    }
    for key in extra_keys:
        out[key] = float(extra[key].float().mean())
    check(w.shape == (chains, mcmc.num_samples, D) and np.all(np.isfinite(w)),
          f"samples have shape {w.shape} or are not finite")
    check(divergences == 0, f"{divergences} divergent transitions after "
                            "warmup")
    check(post_err < 0.05, f"posterior mean is {post_err} from true_w")
    check(stats["glm_prior"] == "slim", "the fused potential's prior term "
          f"runs on the {stats['glm_prior']} data, not on 0 rows")
    check(evals == chains * stats["num_leapfrog"] + stats["init_grad_evals"],
          f"{evals} gradient evaluations != {chains} chains x "
          f"{stats['num_leapfrog']} + {stats['init_grad_evals']} (searches)")
    check(counts["glm_potential_grad"] == evals + 1,
          f"glm_potential_grad: {counts['glm_potential_grad']} launches != "
          f"{evals} gradient evaluations + 1 (the setup's check)")
    return out, w


def run_chees(dev, data):
    """``MCMC(ChEES(logreg_model_glm), 300, 1500, num_chains=8)`` on the
    581,012 x 54 data: lockstep trajectories through the batch leapfrog
    kernel, every chain's gradient through the GLM kernel."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, ChEES
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    mcmc = MCMC(ChEES(logreg_model_glm), num_warmup=CHEES_WARMUP,
                num_samples=CHEES_DRAWS, num_chains=CHEES_CHAINS)
    mcmc.run(0, data["x"], y=data["y"])
    counts = ops.launch_counts()
    out, _ = _ensemble_summary(mcmc, data, counts, ("trajectory_length",
                                                    "num_steps"))
    steps = mcmc.get_extra_fields(group_by_chain=True)["num_steps"]
    out["leapfrog_halfstep_batch_per_leapfrog"] = \
        counts["leapfrog_halfstep_batch"] / out["num_leapfrog"]
    print("ChEES:", json.dumps(out), flush=True)
    check(bool((steps == steps[:1]).all()),
          "the chains report different num_steps at some draw: not lockstep")
    check(out["max_split_rhat"] < RHAT_MAX,
          f"max split R-hat {out['max_split_rhat']} >= {RHAT_MAX}")
    check(counts["leapfrog_halfstep_batch"] == out["num_leapfrog"],
          f"leapfrog_halfstep_batch: {counts['leapfrog_halfstep_batch']} "
          f"launches != {out['num_leapfrog']} ensemble leapfrogs")
    out["profile"] = profile_transitions(mcmc, 20)
    print("ChEES profile:", json.dumps(out["profile"]), flush=True)
    return out, counts


def run_mrw(dev, data, algo, init_w=None):
    """``MCMC(MALA | RWM(logreg_model_glm), 500, 500, num_chains=16)`` on the
    581,012 x 54 data, one ``mala_step`` launch per iteration (RWM's without
    the gradient operand); RWM starts every chain at ``init_w`` through the
    entry point's ``init_params``."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MALA, MCMC, RWM
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwm_mala import mala_step_cuda

    kernel = {"MALA": MALA, "RWM": RWM}[algo]
    ops.reset_launch_counts()
    mcmc = MCMC(kernel(logreg_model_glm), num_warmup=MRW_WARMUP,
                num_samples=MRW_DRAWS, num_chains=MRW_CHAINS)
    init = None if init_w is None else {"w": init_w}
    mcmc.run(0, data["x"], y=data["y"], init_params=init)
    counts = ops.launch_counts()
    without_grad = mala_step_cuda.launches_without_grad
    out, w = _ensemble_summary(mcmc, data, counts)
    out["mala_step_launches_without_grad"] = without_grad
    print(f"{algo}:", json.dumps(out), flush=True)
    iterations = MRW_WARMUP + MRW_DRAWS
    check(counts["mala_step"] == iterations,
          f"mala_step: {counts['mala_step']} launches != {iterations} "
          "iterations")
    want = iterations if algo == "RWM" else 0
    check(without_grad == want, f"{algo}: {without_grad} launches of the "
          f"no-gradient variant, expected {want}")
    out["profile"] = profile_transitions(mcmc, 20)
    print(f"{algo} profile:", json.dumps(out["profile"]), flush=True)
    return out, counts, w.mean((0, 1))


def ensemble_kernel_rows(checks, timing, phases):
    """The kernel-table rows of the batch leapfrog and ``mala_step``: the
    main shape's times (the merged kick, MALA's variant) and bound, the
    other variants' and the large shape's beside them, and the launches of
    every phase that ran the kernel (``phases``: name -> {phase: (summary,
    launch counts)})."""
    from repro_torch.kernels.ops import SPECS
    rows = []
    for name, source, variant, shape in (
            ("leapfrog_halfstep_batch", "leapfrog_batch.cu", "kick=1.0",
             ENS_CHEES),
            ("mala_step", "mala_step.cu", "MALA", ENS_MRW)):
        times, (bound_ms, bound_by), err = timing[(name, variant, shape)]
        runs = phases[name]
        rows.append({
            "name": name, "route": SPECS[name].route,
            "source": "src/repro_torch/csrc/" + source,
            "replaces": SPECS[name].replaces,
            "launches": sum(c[name] for _, c in runs.values()),
            "launches_by_phase": {p: c[name] for p, (_, c) in runs.items()},
            "launches_per_iteration": {
                p: c[name] / o["num_iterations"]
                for p, (o, c) in runs.items()},
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "shape": list(shape), "variant": variant,
            "variants": {
                f"{v} {list(sh)}": {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                    "call_ms": t["call_ms"], "bound_ms": b[0],
                                    "bound_by": b[1]}
                for (n, v, sh), (t, b, _) in timing.items() if n == name}})
    return rows


# ---------------------------------------------------------------------------
# the LM serving slice: Qwen3-8B prefill and KV-cache decode
# ---------------------------------------------------------------------------

def _bf16_close(got, want):
    """Elementwise within one bfloat16 rounding step of the float32-computed
    value (``kernels/ops.py:BF16_RTOL``); returns (ok, max abs
    error, largest error / bound)."""
    from repro_torch.kernels.ops import BF16_ATOL, BF16_RTOL
    err = (got.float() - want.float()).abs()
    bound_ = BF16_RTOL * want.float().abs() + BF16_ATOL
    return bool((err <= bound_).all()), float(err.max()), \
        float((err / bound_).max())


def _kernel_case(kernel, plain, dtype, tol):
    """Run a kernel and its plain version on the same inputs; the outputs
    (tuples) must agree within ``tol`` (float32) or one bfloat16 step."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    errs, ok = [], True
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            err = float((a - b).abs().max())
            ok = ok and err <= tol
        else:
            close, err, _ = _bf16_close(a, b)
            ok = ok and close
        errs.append(err)
    return ok, max(errs)


def rmsnorm_bound(rows, d, dtype):
    """x read and out written once, the float32 weight row; ~3 float32
    operations per element (square-accumulate, two products)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return bound(2 * rows * d * itemsize + 4 * d, 3 * rows * d,
                 torch.float32)


def attention_bound(B, S, H, K, dq, dv, causal, dtype):
    """q, k, v read once, o and lse written once; the score entries this
    mask keeps (S (S + 1) / 2 per head when causal), each a dq-long product
    and a dv-long update (2 operations per multiply-add), at the peak rate
    of the inputs' type (bf16 tensor cores for bf16)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * B * S * (H * dq + K * dq + K * dv + H * dv) \
        + 4 * B * H * S
    entries = B * H * (S * (S + 1) // 2 if causal else S * S)
    return bound(nbytes, entries * (2 * dq + 2 * dv), dtype)


def lm_kernel_checks(dev):
    """``rmsnorm_cuda`` and ``flash_attention_cuda`` against their plain
    versions in float32 (OP_TABLE's 2e-5 and 2e-4) and bfloat16 (one
    rounding step) on the LM's shapes and ragged ones: causal and not, MHA,
    GQA and MQA, dq != dv, S not a multiple of the tile; timings and the
    library yardsticks (``F.rms_norm``, ``F.scaled_dot_product_attention``)
    at the main path's shapes in bfloat16."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.kernels.ops import SPECS
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref

    results, timing = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(RMS_SHAPES):
            gen = torch.Generator().manual_seed(seed)
            x = torch.randn(shape, generator=gen).to(dtype).to(dev)
            w = (torch.rand(shape[-1], generator=gen) + 0.5).to(dev)
            ok, err = _kernel_case(lambda: (rmsnorm_cuda(x, w),),
                                   lambda: (rmsnorm_ref(x, w),), dtype,
                                   SPECS["rmsnorm"].tol)
            results.append({"name": "rmsnorm", "shape": list(shape),
                            "dtype": str(dtype), "max_abs_err": err,
                            "within_bound": ok})
            check(ok, f"rmsnorm kernel disagrees at {shape} {dtype}: {err}")
            if dtype == torch.bfloat16 and shape in RMS_TIMED:
                rows, d = math.prod(shape[:-1]), shape[-1]
                t = timings(lambda: rmsnorm_cuda(x, w),
                            lambda: rmsnorm_ref(x, w), 100)
                wl = w.to(dtype)
                t["library_ms"] = device_ms(
                    lambda: F.rms_norm(x, (d,), wl, 1e-6), 100)
                timing[("rmsnorm", shape)] = (t, rmsnorm_bound(rows, d,
                                                               dtype), err)
        for seed, (B, S, H, K, dq, dv, causal) in enumerate(ATTN_SHAPES):
            gen = torch.Generator().manual_seed(100 + seed)
            q, k, v = (torch.randn(s, generator=gen).to(dtype).to(dev)
                       for s in ((B, S, H, dq), (B, S, K, dq), (B, S, K, dv)))
            ok, err = _kernel_case(
                lambda: flash_attention_cuda(q, k, v, causal=causal),
                lambda: flash_attention_ref(q, k, v, causal=causal), dtype,
                SPECS["attention"].tol)
            shape = [B, S, H, K, dq, dv]
            results.append({"name": "attention", "shape": shape,
                            "causal": causal, "dtype": str(dtype),
                            "max_abs_err": err, "within_bound": ok})
            check(ok, f"flash_attention kernel disagrees at {shape} causal="
                      f"{causal} {dtype}: {err}")
            if dtype == torch.bfloat16 and (B, S, H, K, dq, dv, causal) \
                    == ATTN_MAIN:
                t = timings(lambda: flash_attention_cuda(q, k, v),
                            lambda: flash_attention_ref(q, k, v), 10)
                qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
                t["library_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
                timing[("attention", ATTN_MAIN)] = (
                    t, attention_bound(B, S, H, K, dq, dv, causal, dtype),
                    err)
    return results, timing


def _gen_tokens(vocab, batch, length, dev):
    """Prompts from numpy seed 1 in [3, vocab), as the launcher makes them."""
    prompt = np.random.default_rng(1).integers(3, vocab, (batch, length))
    return torch.from_numpy(prompt.astype(np.int32)).to(dev)


def device_profile(fn, calls):
    """Device busy share of ``calls`` calls of ``fn`` under
    ``torch.profiler``, device ms per call and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(getattr(a, "self_device_time_total", 0.0), a.count, a.key)
            for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        return {"device_busy_share": None,
                "note": "the profiler recorded no device time"}
    return {
        "calls": calls, "wall_ms_per_call_profiled": wall_us / 1e3 / calls,
        "device_busy_ms_per_call": busy_us / 1e3 / calls,
        "device_busy_share": busy_us / wall_us,
        "device_kernels_per_call": sum(r[1] for r in rows) / calls,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_call": t / 1e3 / calls,
             "launches_per_call": c / calls}
            for t, c, k in sorted(rows, reverse=True)[:8]]}


def count_syncs(fn):
    """Synchronizing CUDA calls made by ``fn`` (the host waiting for the
    card), counted through ``torch.cuda.set_sync_debug_mode``'s warnings."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def decode_breakdown(lm, w, prompt, steps):
    """Wall ms of ``steps`` decode tokens split into the model (host time to
    issue ``decode_step``, then the wait for the card to finish it) and the
    ``next_token`` sample site (host-drawn uniforms copied to the card,
    argmax), each ended by a synchronize.  Decode attends over the whole
    cache under a mask, so its cost does not depend on the position."""
    from repro_torch.core import dist
    from repro_torch.core.primitives import sample

    B = prompt.shape[0]
    cache = lm.init_cache(B, prompt.shape[1] + LM_TOKENS, device=prompt.device)
    issue, wait, draw = [], [], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(w, prompt[:, t:t + 1], cache, t)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sample("next_token", dist.Categorical(logits=logits / 1.0),
               generator=torch.Generator().manual_seed(t))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        issue.append(t1 - t0)
        wait.append(t2 - t1)
        draw.append(t3 - t2)
    ms = lambda xs: 1e3 * float(np.median(xs))  # noqa: E731
    return {"steps": steps, "model_issue_ms": ms(issue),
            "model_wait_ms": ms(wait),
            "model_ms": ms([a + b for a, b in zip(issue, wait)]),
            "sampling_ms": ms(draw)}


def run_lm(dev):
    """The full Qwen3-8B (36 layers, bf16, params drawn on the card from
    seed 0): ``make_prefill_step`` at B = 4, P = 512, then the launcher's
    serving loop (``serve.generate``: the prompt teacher-forced through
    ``serve_step``, then 32 sampled tokens), each with the launch counters
    set to 0 before and read after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import LM, count_params

    cfg = get_config("qwen3-8b")
    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(cfg)
    B, P, V = LM_BATCH, LM_PROMPT, cfg.vocab_size
    prompt = _gen_tokens(V, B, P, dev)
    prefill = make_prefill_step(lm)

    ops.reset_launch_counts()
    last = prefill(w, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_counts = ops.launch_counts()
    t0 = time.perf_counter()
    for _ in range(LM_PREFILL_REPS):
        prefill(w, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0) / LM_PREFILL_REPS

    ops.reset_launch_counts()
    result = serve.generate(lm, w, prompt, LM_TOKENS, temperature=1.0)
    serve_counts = ops.launch_counts()
    steps_run = P - 1 + LM_TOKENS
    first, seq = result["first_logits"], result["tokens"]

    diff = (first.float() - last.float())
    rel_rms = float(diff.pow(2).mean().sqrt()
                    / last.float().pow(2).mean().sqrt())
    top1 = (first.argmax(-1) == last.argmax(-1)).float().mean()
    out = {
        "arch": cfg.name, "params": n_params, "batch": B, "prompt_len": P,
        "new_tokens": LM_TOKENS, "init_seconds": init_s,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "prefill_launches": prefill_counts,
        "teacher_forced_ms_per_step": 1e3 * result["teacher_forced_seconds"]
        / (P - 1),
        "sampled_ms_per_token": 1e3 * result["sampled_seconds"] / LM_TOKENS,
        "sampled_tokens_per_s": B * LM_TOKENS / result["sampled_seconds"],
        "serve_launches": serve_counts, "serve_steps": steps_run,
        "prefill_vs_decode_logits": {
            "max_abs_err": float(diff.abs().max()), "rel_rms_err": rel_rms,
            "rel_rms_bound": LM_REL_RMS_MAX,
            "top1_agreement": float(top1),
            "logit_rms": float(last.float().pow(2).mean().sqrt())},
    }
    print("Qwen3-8B serving:", json.dumps(out), flush=True)
    check(tuple(last.shape) == (B, V) and tuple(first.shape) == (B, V),
          f"logits have shapes {tuple(last.shape)}, {tuple(first.shape)}")
    check(bool(torch.isfinite(last).all() and torch.isfinite(first).all()),
          "a prefill or decode logit is not finite")
    check(tuple(seq.shape) == (B, P + LM_TOKENS)
          and bool(((seq >= 0) & (seq < V)).all()),
          f"tokens of shape {tuple(seq.shape)} or outside [0, {V})")
    check(torch.equal(seq[:, :P], prompt), "the prompt was not kept")
    check(rel_rms <= LM_REL_RMS_MAX,
          f"prefill and teacher-forced decode logits at P-1 differ by "
          f"{rel_rms} (relative rms) > {LM_REL_RMS_MAX}")
    per_pass = 4 * cfg.num_layers + 1
    check(prefill_counts["rmsnorm"] == per_pass
          and prefill_counts["attention"] == cfg.num_layers,
          f"prefill launched rmsnorm {prefill_counts['rmsnorm']} and "
          f"attention {prefill_counts['attention']} times, not {per_pass} "
          f"and {cfg.num_layers}")
    check(serve_counts["rmsnorm"] == per_pass * steps_run
          and serve_counts["attention"] == 0,
          f"serving launched rmsnorm {serve_counts['rmsnorm']} and attention "
          f"{serve_counts['attention']} times over {steps_run} steps, not "
          f"{per_pass} and 0 per step")

    out["decode_breakdown"] = decode_breakdown(lm, w, prompt, 16)
    step = make_serve_step(lm)
    cache = lm.init_cache(B, P + LM_TOKENS, device=dev)
    tok = prompt[:, :1]

    def serve_one():
        step(w, cache, tok, 0, torch.Generator().manual_seed(0))
    out["decode_breakdown"]["host_syncs_per_step"] = count_syncs(serve_one)
    out["prefill_host_syncs"] = count_syncs(
        lambda: prefill(w, {"tokens": prompt}))
    out["decode_profile"] = device_profile(serve_one, 8)
    out["prefill_profile"] = device_profile(
        lambda: prefill(w, {"tokens": prompt}), 2)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print("Qwen3-8B breakdown:", json.dumps(
        {k: out[k] for k in ("decode_breakdown", "decode_profile",
                             "prefill_profile", "prefill_host_syncs",
                             "peak_mem_gb")}), flush=True)
    return out


def run_lm_f32_check(dev):
    """A full-width, 2-layer float32 Qwen3 (params from seed 0 on the card)
    through the kernels and through the plain versions on the card
    (``ops.SPECS`` pointed at the plain versions for the second run): the
    prefill's last logits, and LM_F32_DECODE_STEPS decode steps of the
    prompt teacher-forced into a fresh cache (the norms at the decode rows).
    In float32 the two differ only by the kernels' own rounding, so the
    bound is tight: LM_F32_REL_TOL of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import LM

    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32")
    lm = LM(cfg)
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    prompt = _gen_tokens(cfg.vocab_size, LM_BATCH, LM_PROMPT, dev)
    prefill = make_prefill_step(lm)
    steps = LM_F32_DECODE_STEPS

    def decode():
        cache = lm.init_cache(LM_BATCH, steps, device=dev)
        logits = []
        for t in range(steps):
            lg, cache = lm.decode_step(w, prompt[:, t:t + 1], cache, t)
            logits.append(lg)
        return torch.stack(logits)

    ops.reset_launch_counts()
    got = prefill(w, {"tokens": prompt})
    prefill_counts = ops.launch_counts()
    ops.reset_launch_counts()
    got_dec = decode()
    decode_counts = ops.launch_counts()
    saved = dict(ops.SPECS)
    try:
        for name in ("rmsnorm", "attention"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        want = prefill(w, {"tokens": prompt})
        want_dec = decode()
    finally:
        ops.SPECS.update(saved)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = LM_F32_REL_TOL * max(1.0, float(want.abs().max()))
    dec_err = float((got_dec - want_dec).abs().max())
    dec_tol = LM_F32_REL_TOL * max(1.0, float(want_dec.abs().max()))
    out = {"layers": 2, "dtype": "float32", "max_abs_err": err, "tol": tol,
           "max_abs_logit": float(want.abs().max()),
           "launches": prefill_counts, "decode_steps": steps,
           "decode_max_abs_err": dec_err, "decode_tol": dec_tol,
           "decode_launches": decode_counts}
    print("Qwen3 2-layer float32 kernels vs plain:", json.dumps(out),
          flush=True)
    check(bool(torch.isfinite(got).all() and torch.isfinite(got_dec).all()),
          "a float32 logit is not finite")
    check(err <= tol, f"float32 prefill through the kernels differs from the "
                      f"plain versions by {err} > {tol}")
    check(dec_err <= dec_tol, f"float32 decode through the kernels differs "
                              f"from the plain versions by {dec_err} > "
                              f"{dec_tol}")
    check(prefill_counts["rmsnorm"] == 9 and prefill_counts["attention"] == 2,
          f"2-layer prefill launched {prefill_counts}")
    check(decode_counts["rmsnorm"] == 9 * steps
          and decode_counts["attention"] == 0,
          f"{steps} 2-layer decode steps launched {decode_counts}")
    return out


def lm_kernel_rows(checks, timing, lm, train, ssm):
    """The kernel-table rows of ``rmsnorm`` and ``attention``: main-shape
    times and bounds, variants beside them, and the launches of the serving
    phases, of the training run and of the mamba2 serving phases."""
    from repro_torch.kernels.ops import SPECS
    rows = []
    for name, source, key in (
            ("rmsnorm", "rmsnorm.cu", ("rmsnorm", RMS_TIMED[0])),
            ("attention", "flash_attention.cu", ("attention", ATTN_MAIN))):
        times, (bound_ms, bound_by), err = timing[key]
        by_phase = {"prefill": lm["prefill_launches"][name],
                    "serve": lm["serve_launches"][name],
                    "train": train["launches"][name],
                    "mamba2_prefill": ssm["prefill_launches"].get(name, 0),
                    "mamba2_serve": ssm["serve_launches"].get(name, 0)}
        row = {
            "name": name, "route": SPECS[name].route,
            "source": "src/repro_torch/csrc/" + source,
            "replaces": SPECS[name].replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "launches_per_prefill": by_phase["prefill"],
            "launches_per_decode_step": by_phase["serve"] / lm["serve_steps"],
            "launches_per_train_step": train["launches_per_step"][name],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"],
            "library": {"rmsnorm": "torch.nn.functional.rms_norm",
                        "attention": "torch.nn.functional."
                        "scaled_dot_product_attention(enable_gqa=True)"}[name],
            "shape": list(key[1]), "dtype": "bfloat16"}
        if name == "rmsnorm":
            row["variants"] = {
                str(list(shape)): {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                   "library_ms": t["library_ms"],
                                   "bound_ms": b[0], "bound_by": b[1]}
                for (n, shape), (t, b, _) in timing.items()
                if n == "rmsnorm" and shape != RMS_TIMED[0]}
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the training slice: gemma-2b MAP training
# ---------------------------------------------------------------------------

def rmsnorm_bwd_bound(rows, d, dtype):
    """x and g read, dx written once, the weight read and dw written; ~8
    float32 operations per element."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return bound(3 * rows * d * itemsize + 8 * d, 8 * rows * d,
                 torch.float32)


def attention_bwd_bound(B, S, H, K, dq, dv, causal, dtype, which):
    """The dq pass reads q, k, v, o, dO and lse and writes dq and delta;
    the dkv pass reads q, k, v, dO, lse and delta and writes dk and dv.  Per
    score entry the mask keeps, the dq pass multiplies 2 dq + dv long
    vectors (s, dq; dp) and the dkv pass 2 dq + 2 dv (s, dk; dp, dv), 2
    operations per multiply-add, at the inputs' type's peak rate."""
    it = torch.tensor([], dtype=dtype).element_size()
    q, k, v, o = B * S * H * dq, B * S * K * dq, B * S * K * dv, B * S * H * dv
    rows = 4 * B * H * S
    entries = B * H * (S * (S + 1) // 2 if causal else S * S)
    if which == "dq":
        return bound(it * (q + k + v + 2 * o + q) + 2 * rows,
                     entries * 2 * (2 * dq + dv), dtype)
    return bound(it * (q + k + v + o + k + v) + 2 * rows,
                 entries * 2 * (2 * dq + 2 * dv), dtype)


def xent_bound(T, d, V, dtype):
    """x, W and the labels read once, ce, z_loss and lse written; the
    logits' 2 T d V operations at the inputs' type's peak rate."""
    it = torch.tensor([], dtype=dtype).element_size()
    return bound(it * (T * d + d * V) + 4 * T + 12 * T, 2.0 * T * d * V,
                 dtype)


def _rmsnorm_bwd_case(x, w, g, dtype, kernel, plain, tol):
    """dx as ``_kernel_case`` holds an output; dw, a float32 sum over every
    row, within ``tol`` of its largest entry (which grows with the rows)."""
    (dx, dw), (rdx, rdw) = kernel(x, w, g), plain(x, w, g)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        dx_err = float((dx - rdx).abs().max())
        ok = dx_err <= tol
    else:
        ok, dx_err, _ = _bf16_close(dx, rdx)
    dw_err = float((dw - rdw).abs().max())
    ok = ok and dw_err <= tol * max(1.0, float(rdw.abs().max()))
    return ok, max(dx_err, dw_err)


def _xent_inputs(T, d, V, tied, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn((V, d) if tied else (d, V), generator=gen, device=dev)
         * 0.05).to(dtype)
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    return x, (w.T if tied else w), labels


def train_kernel_checks(dev):
    """``rmsnorm_bwd_cuda``, the flash-attention dq and dkv passes and
    ``softmax_xent_cuda`` against their plain versions in float32
    (OP_TABLE's bounds; a dw summed over R rows to 2e-5 sqrt(R)) and
    bfloat16 (one rounding step of a bfloat16 output): causal and not, MHA,
    GQA and MQA, head dims 128 and 256, dq != dv, a ragged S, T and V, the
    xent weight in both layouts; then times at gemma-2b's training shapes in
    bfloat16 beside the library yardsticks (SDPA's backward for dq/dkv)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import softmax_xent as xe
    from repro_torch.kernels.ops import BACKWARD, SPECS
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_bwd_ref

    results, timing = [], {}

    def record(name, shape, dtype, ok, err, **extra):
        results.append({"name": name, "shape": list(shape),
                        "dtype": str(dtype), "max_abs_err": err,
                        "within_bound": ok, **extra})
        check(ok, f"{name} kernel disagrees at {shape} {dtype}: {err}")

    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(RMS_BWD_SHAPES):
            gen = torch.Generator().manual_seed(200 + seed)
            x, g = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                    for _ in range(2))
            w = (torch.rand(shape[-1], generator=gen) + 0.5).to(dev)
            rows = math.prod(shape[:-1])
            ok, err = _rmsnorm_bwd_case(x, w, g, dtype, rmsnorm_bwd_cuda,
                                        rmsnorm_bwd_ref,
                                        BACKWARD["rmsnorm_bwd"].tol)
            record("rmsnorm_bwd", shape, dtype, ok, err)
            if dtype == torch.bfloat16 and shape == RMS_BWD_MAIN:
                t = timings(lambda: rmsnorm_bwd_cuda(x, w, g),
                            lambda: rmsnorm_bwd_ref(x, w, g), 50)
                t["library_ms"] = backward_device_ms(
                    lambda a, b: F.rms_norm(a, (shape[-1],), b, 1e-6),
                    (x.detach().requires_grad_(),
                     w.to(dtype).requires_grad_()), g, 50)
                timing["rmsnorm_bwd"] = (t, rmsnorm_bwd_bound(
                    rows, shape[-1], dtype), err)
        for seed, case in enumerate(ATTN_BWD_SHAPES):
            B, S, H, K, dq, dv, causal = case
            gen = torch.Generator().manual_seed(300 + seed)
            q, k, v, do = (torch.randn(s, generator=gen).to(dtype).to(dev)
                           for s in ((B, S, H, dq), (B, S, K, dq),
                                     (B, S, K, dv), (B, S, H, dv)))
            o, lse = (t.contiguous() for t in
                      fl.flash_attention_ref(q, k, v, causal=causal))
            delta = fl.flash_attention_dq_ref(q, k, v, o, lse, do,
                                              causal)[1].contiguous()
            tol = BACKWARD["attention_dq"].tol
            dq_kernel = lambda: fl.flash_attention_dq_cuda(  # noqa: E731
                q, k, v, o, lse, do, causal)
            dq_plain = lambda: fl.flash_attention_dq_ref(  # noqa: E731
                q, k, v, o, lse, do, causal)
            dkv_kernel = lambda: fl.flash_attention_dkv_cuda(  # noqa: E731
                q, k, v, lse, delta, do, causal)
            dkv_plain = lambda: fl.flash_attention_dkv_ref(  # noqa: E731
                q, k, v, lse, delta, do, causal)
            ok, err = _kernel_case(dq_kernel, dq_plain, dtype, tol)
            record("attention_dq", [B, S, H, K, dq, dv], dtype, ok, err,
                   causal=causal)
            ok, err_kv = _kernel_case(dkv_kernel, dkv_plain, dtype, tol)
            record("attention_dkv", [B, S, H, K, dq, dv], dtype, ok, err_kv,
                   causal=causal)
            if dtype == torch.bfloat16 and case == ATTN_BWD_MAIN:
                lib = sdpa_backward_ms(q, k, v, do, causal)
                for name, kern, plain, e in (
                        ("attention_dq", dq_kernel, dq_plain, err),
                        ("attention_dkv", dkv_kernel, dkv_plain, err_kv)):
                    t = timings(kern, plain, 5)
                    t.update(lib)
                    timing[name] = (t, attention_bwd_bound(
                        *case, dtype, name[len("attention_"):]), e)
        for seed, (T, d, V, tied) in enumerate(XENT_SHAPES):
            x, w, labels = _xent_inputs(T, d, V, tied, dtype, 400 + seed,
                                        dev)
            ok, err = _kernel_case(
                lambda: xe.softmax_xent_cuda(x, w, labels, 1e-4),
                lambda: xe.softmax_xent_ref(x, w, labels, 1e-4), dtype,
                SPECS["softmax_xent"].tol)
            record("softmax_xent", [T, d, V], dtype, ok, err,
                   layout="(V, d) transposed" if tied else "(d, V)")
            if dtype == torch.bfloat16 and (T, d, V, tied) == XENT_MAIN:
                t = timings(lambda: xe.softmax_xent_cuda(x, w, labels, 1e-4),
                            lambda: xe.softmax_xent_ref(x, w, labels, 1e-4),
                            2)
                t["library_ms"] = None
                t["logits_matmul_ms"] = device_ms(
                    lambda: torch.matmul(x, w), 2)
                timing["softmax_xent"] = (t, xent_bound(T, d, V, dtype), err)
            del x, w, labels
    torch.cuda.empty_cache()
    return results, timing


def sdpa_backward_ms(q, k, v, do, causal):
    """The library yardstick of the two backward passes: the backward of
    ``F.scaled_dot_product_attention(enable_gqa=True)``, which computes dq,
    dk and dv in one call (device time, as the kernels beside it)."""
    import torch.nn.functional as F
    leaves = tuple(a.transpose(1, 2).detach().requires_grad_()
                   for a in (q, k, v))
    return {"library_ms": backward_device_ms(
        lambda qt, kt, vt: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True),
        leaves, do.transpose(1, 2), 5)}


def run_train(dev):
    """The full gemma-2b (18 layers, bf16, params drawn on the card from
    seed 0, ``LM(cfg, remat="full")``): ``make_train_state`` and
    ``make_train_step`` (MAP loss with the handler-scored log-prior, 2
    microbatches, clip, AdamW) for TRAIN_STEPS steps on one fixed batch of
    ``SyntheticLMData``, the launch counters set to 0 before and read
    after; then a profiled step, and ``launch.train.main`` for 2 steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM, count_params

    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg, remat="full")
    hp = steps_mod.TrainHParams(learning_rate=TRAIN_LR,
                                warmup_steps=TRAIN_WARMUP,
                                num_microbatches=TRAIN_MICROBATCHES)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = steps_mod.make_train_state(
        lm, hp, rng=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                            seed=0).batch_at(0, device=dev)
    step = steps_mod.make_train_step(lm, hp, total_tokens=tokens)

    history, step_s = [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in m.items()})
    counts = ops.launch_counts()
    n_steps = state["step"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # every step after the first (which allocates the optimizer's moments
    # and the allocator's pools)
    ms = 1e3 * float(np.median(step_s[1:]))
    L = cfg.num_layers
    per_mb = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
              "attention": 2 * L, "attention_dq": L, "attention_dkv": L,
              "softmax_xent": 1}
    expected = {k: v * TRAIN_MICROBATCHES * TRAIN_STEPS
                for k, v in per_mb.items()}
    out = {"arch": cfg.name, "params": count_params(cfg),
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "microbatches": TRAIN_MICROBATCHES, "steps": n_steps,
           "init_seconds": init_s, "step_seconds": step_s,
           "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
           "history": history, "launches": counts,
           "launches_per_step": {k: counts[k] / TRAIN_STEPS
                                 for k in expected},
           "peak_mem_gb": peak_gb}
    print("gemma-2b training:", json.dumps(out), flush=True)
    check(all(math.isfinite(h[k]) for h in history
              for k in ("loss", "ce", "z_loss", "log_prior", "grad_norm")),
          "a training loss, metric or grad norm is not finite")
    check(history[-1]["ce"] < history[0]["ce"]
          and history[-1]["loss"] < history[0]["loss"],
          f"the loss did not fall over {TRAIN_STEPS} steps on a fixed batch: "
          f"ce {history[0]['ce']} -> {history[-1]['ce']}, MAP loss "
          f"{history[0]['loss']} -> {history[-1]['loss']}")
    check(n_steps == TRAIN_STEPS, f"state['step'] is {n_steps}")
    check(all(counts[k] == v for k, v in expected.items()),
          f"{TRAIN_STEPS} training steps launched {counts}, not {expected}")

    out["profile"] = device_profile(lambda: step(state, batch), 1)
    print("gemma-2b training profile:", json.dumps(out["profile"]),
          flush=True)
    del state, step, batch
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lstate, lhist = train_mod.main([
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_LAUNCHER_STEPS),
        "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
        "--microbatches", str(TRAIN_MICROBATCHES), "--log-every", "1"])
    out["launcher"] = {"seconds": time.perf_counter() - t0,
                       "steps": lstate["step"], "history": lhist,
                       "launches": ops.launch_counts()}
    print("train launcher:", json.dumps(out["launcher"]), flush=True)
    check(lstate["step"] == TRAIN_LAUNCHER_STEPS
          and all(math.isfinite(h["loss"]) for h in lhist),
          f"the launcher ran {lstate['step']} steps: {lhist}")
    del lstate
    torch.cuda.empty_cache()
    return out


def run_train_f32_check(dev):
    """A full-width, TRAIN_F32_LAYERS-layer float32 gemma (params from seed 0
    on the card, remat "full"): the loss and every gradient leaf of one
    microbatch through the kernels, and again through the plain versions on
    the card (``ops.SPECS`` and ``ops.BACKWARD`` pointed at them).  In
    float32 the two differ by the kernels' own rounding: the bound is
    TRAIN_F32_REL_TOL of the largest |grad| (of |loss| for the loss)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.optim import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_F32_LAYERS, dtype="float32")
    lm = LM(cfg, remat="full")
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    batch = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ,
                            TRAIN_BATCH // TRAIN_MICROBATCHES,
                            seed=0).batch_at(0, device=dev)

    def loss_and_grads():
        wg = tree_map(lambda p: p.detach().requires_grad_(), w)
        loss, _ = lm.forward(wg, batch)
        grads = torch.autograd.grad(loss, tree_leaves(wg))
        return loss.detach(), grads

    ops.reset_launch_counts()
    got_loss, got = loss_and_grads()
    counts = ops.launch_counts()
    saved, saved_bwd = dict(ops.SPECS), dict(ops.BACKWARD)
    try:
        for name in ("rmsnorm", "attention", "softmax_xent"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        for name in ("rmsnorm_bwd", "attention_dq", "attention_dkv"):
            ops.BACKWARD[name] = saved_bwd[name]._replace(
                kernel=saved_bwd[name].ref)
        want_loss, want = loss_and_grads()
    finally:
        ops.SPECS.update(saved)
        ops.BACKWARD.update(saved_bwd)
    torch.cuda.synchronize()
    max_grad = max(float(g.abs().max()) for g in want)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    tol = TRAIN_F32_REL_TOL * max_grad
    loss_err = float((got_loss - want_loss).abs())
    loss_tol = TRAIN_F32_REL_TOL * max(1.0, float(want_loss.abs()))
    L = TRAIN_F32_LAYERS
    expected = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
                "attention": 2 * L, "attention_dq": L, "attention_dkv": L,
                "softmax_xent": 1}
    out = {"layers": L, "dtype": "float32", "loss": float(want_loss),
           "loss_abs_err": loss_err, "loss_tol": loss_tol,
           "grad_max_abs_err": err, "max_abs_grad": max_grad, "grad_tol": tol,
           "grad_leaves": len(got), "launches": counts}
    print("gemma 2-layer float32 training kernels vs plain:", json.dumps(out),
          flush=True)
    check(math.isfinite(float(got_loss))
          and all(bool(torch.isfinite(g).all()) for g in got),
          "a float32 loss or gradient is not finite")
    check(loss_err <= loss_tol, f"float32 loss through the kernels differs "
                                f"by {loss_err} > {loss_tol}")
    check(err <= tol, f"float32 gradients through the kernels differ from "
                      f"the plain versions by {err} > {tol}")
    check(all(counts[k] == v for k, v in expected.items()),
          f"the 2-layer float32 step launched {counts}, not {expected}")
    return out


def train_kernel_rows(timing, checks, train):
    """The kernel-table rows of the training slice's four kernels: times
    and bounds at gemma-2b's shapes, and the launches of the 8-step run."""
    from repro_torch.kernels.ops import BACKWARD, SPECS
    rows = []
    libraries = {"rmsnorm_bwd": "backward of torch.nn.functional.rms_norm:"
                 " dx and dw in one call",
                 "attention_dq": "backward of torch.nn.functional."
                 "scaled_dot_product_attention(enable_gqa=True): dq, dk and "
                 "dv in one call",
                 "softmax_xent": None}
    libraries["attention_dkv"] = libraries["attention_dq"]
    for name, source, shape in (
            ("rmsnorm_bwd", "rmsnorm.cu", RMS_BWD_MAIN),
            ("attention_dq", "flash_attention_bwd.cu", ATTN_BWD_MAIN),
            ("attention_dkv", "flash_attention_bwd.cu", ATTN_BWD_MAIN),
            ("softmax_xent", "softmax_xent.cu", XENT_MAIN)):
        times, (bound_ms, bound_by), err = timing[name]
        spec = SPECS[name] if name in SPECS else BACKWARD[name]
        rows.append({
            "name": name, "route": spec.route,
            "source": "src/repro_torch/csrc/" + source,
            "replaces": spec.replaces,
            "launches": train["launches"][name],
            "launches_per_step": train["launches_per_step"][name],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"], "library": libraries[name],
            **({"logits_matmul_ms": times["logits_matmul_ms"]}
               if "logits_matmul_ms" in times else {}),
            "shape": list(shape), "dtype": "bfloat16"})
    return rows


# ---------------------------------------------------------------------------
# the Mamba-2 slice: mamba2-370m prefill (ssd_scan) and O(1) decode
# ---------------------------------------------------------------------------

def ssd_work(b, l, h, p, g, n, chunk, dtype):
    """(bytes, operations) of one scan: x, B, C and dt read once, y and the
    float32 state written once; the multiply-adds this run's chunks need:
    the causal scores C Bᵀ (c (c + 1) / 2 per chunk, each n long) once per
    B/C group, their product with x under each head's decay (p long), and
    each head's entering state's part and state update (c p n each)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * l * h * p + 2 * b * l * g * n) \
        + 4 * (b * l * h + 2 * h + b * h * p * n)
    nc, tri = l // chunk, chunk * (chunk + 1) // 2
    macs = b * g * nc * tri * n + b * h * nc * (tri * p + 2 * chunk * p * n)
    return nbytes, 2 * macs


def ssd_bound(b, l, h, p, g, n, chunk, dtype):
    """The scan's bound at the peak rate of the inputs' type (bf16 tensor
    cores for bf16)."""
    return bound(*ssd_work(b, l, h, p, g, n, chunk, dtype), dtype)


def ssm_serving_bounds(cfg, w, cache, batch, length):
    """The least time of the mamba2 serving phases on this run's tensors.
    Prefill of ``batch`` x ``length`` tokens: the in- and out-projections'
    products over every token, the unembedding at the last position and
    every layer's scan (``ssd_work``) at the bf16 rate, beside every weight
    read once.  Decode step: every weight but the embedding table (of which
    it reads ``batch`` rows) read once, the state and conv caches read and
    written once."""
    from repro_torch.models.ssm import N_GROUPS

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    mixer = w["layers"]["p0"]["mixer"]
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    d_in, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    tokens = batch * length
    products = 2 * tokens * (mixer["w_in"].numel() + mixer["w_out"].numel()) \
        + 2 * batch * d * V
    _, scan = ssd_work(batch, length, h, d_in // h, N_GROUPS, n,
                       min(cfg.ssm_chunk, length), cfg.torch_dtype)
    weights = nbytes(w)
    prefill = bound(weights, products + L * scan, cfg.torch_dtype)
    decode_bytes = weights - nbytes(w["embed"]) + 2 * nbytes(cache)
    decode = bound(decode_bytes, 0, cfg.torch_dtype)
    return {"prefill_bound_ms": prefill[0], "prefill_bound_by": prefill[1],
            "prefill_flops": products + L * scan, "prefill_scan_flops": L * scan,
            "decode_bound_ms": decode[0], "decode_bound_by": decode[1],
            "decode_bytes": decode_bytes, "weight_bytes": weights,
            "cache_bytes": nbytes(cache)}


def _ssd_inputs(b, l, h, p, g, n, dtype, dev, seed):
    """Inputs in mamba2's ranges: dt in [1e-3, 0.1], A in [-16, -1], x, B
    and C in ``dtype``, the rest float32."""
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
    return x, dt, A, B, C, 0.5 + rand(h), 0.1 * randn(b, h, p, n)


def ssm_kernel_checks(dev):
    """``ssd_scan_cuda`` against ``ssd_scan_ref`` on the card: float32 y
    and state within OP_TABLE's 1e-4; bfloat16 y within one rounding step
    and the float32 state within 1e-4 of its largest entry; without D, with
    D, with D and h0, on SSD_SHAPES; a ragged length raises; ``SsdScan``
    launches the kernel once forward and its gradients equal autograd of
    ``ssd_scan_ref`` (float32, within 1e-4 of each gradient's largest
    entry); then times at the main
    shape in bfloat16.  No single PyTorch call computes the scan."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    tol = ops.SPECS["ssd_scan"].tol
    results, timing = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(SSD_SHAPES):
            b, l, h, p, g, n, chunk = shape
            x, dt, A, B, C, D, h0 = _ssd_inputs(b, l, h, p, g, n, dtype, dev,
                                                seed)
            for label, kw in (("", {}), ("D", {"D": D}),
                              ("D,h0", {"D": D, "h0": h0})):
                y, st = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, **kw)
                ry, rst = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk, **kw)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    y_err = float((y - ry).abs().max())
                    y_ok = y_err <= tol
                else:
                    y_ok, y_err, _ = _bf16_close(y, ry)
                st_err = float((st - rst).abs().max())
                st_tol = tol * (1.0 if dtype == torch.float32
                                else max(1.0, float(rst.abs().max())))
                ok = y_ok and st_err <= st_tol and bool(
                    torch.isfinite(y).all() and torch.isfinite(st).all())
                results.append({"name": "ssd_scan", "shape": list(shape),
                                "dtype": str(dtype), "operands": label,
                                "max_abs_err": max(y_err, st_err),
                                "y_max_abs_err": y_err,
                                "state_max_abs_err": st_err,
                                "state_tol": st_tol, "within_bound": ok})
                check(ok, f"ssd_scan kernel disagrees at {shape} {dtype} "
                          f"[{label}]: y {y_err}, state {st_err}")
                if label == "D":
                    main_err = y_err
            if dtype == torch.bfloat16 and shape == SSD_MAIN:
                t = timings(
                    lambda: ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                              D=D),
                    lambda: ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                             D=D), 5)
                t["library_ms"] = None
                timing["ssd_scan"] = (t, ssd_bound(*shape, dtype), main_err)
        b, l, h, p, g, n, chunk = SSD_SHAPES[-1]
        try:
            ssd.ssd_scan_cuda(x[:, :l - 1], dt[:, :l - 1], A, B[:, :l - 1],
                              C[:, :l - 1], chunk=chunk)
            raised = False
        except ValueError:
            raised = True
        check(raised, "ssd_scan_cuda took a length that is not a whole "
                      "number of chunks")

    b, l, h, p, g, n, chunk = SSD_BWD_SHAPE
    args = _ssd_inputs(b, l, h, p, g, n, torch.float32, dev, 99)
    gen = torch.Generator(device=dev).manual_seed(100)
    gy = torch.randn((b, l, h, p), generator=gen, device=dev)
    gs = torch.randn((b, h, p, n), generator=gen, device=dev)

    def grads(scan):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        y, st = scan(*leaves)
        ((y * gy).sum() + (st * gs).sum()).backward()
        return [a.grad for a in leaves]

    # the backward recomputes the plain version, so what the card can show
    # is that SsdScan runs the kernel forward (one launch) and wires the
    # plain gradient through: autograd of ssd_scan_ref called directly
    ops.reset_launch_counts()
    got = grads(lambda *a: ssd.SsdScan.apply(*a, chunk, ssd.ssd_scan_cuda))
    fwd_launches = ops.launch_counts()["ssd_scan"]
    want = grads(lambda x, dt, A, B, C, D, h0: ssd.ssd_scan_ref(
        x, dt, A, B, C, chunk=chunk, D=D, h0=h0))
    errs = [float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
            for a, r in zip(got, want)]
    ok = max(errs) <= tol and fwd_launches == 1
    results.append({"name": "ssd_scan_backward", "shape": list(SSD_BWD_SHAPE),
                    "dtype": "torch.float32", "max_rel_err": max(errs),
                    "kernel_launches": fwd_launches, "within_bound": ok})
    check(ok, f"SsdScan launched the kernel {fwd_launches} times (not 1) or "
              f"its gradients differ from autograd of the plain version by "
              f"{max(errs)} of the largest gradient")
    return results, timing


def run_ssm(dev):
    """The full mamba2-370m (48 layers, bf16, params drawn on the card from
    seed 0): ``make_prefill_step`` at B = 4, P = 2048, then the launcher's
    serving loop (``serve.generate`` over a 512-token prompt, then 32
    sampled tokens), each with the launch counters set to 0 before and read
    after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import LM, count_params

    cfg = get_config(SSM_ARCH)
    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, P, V = SSM_BATCH, SSM_PREFILL_LEN, SSM_PROMPT, cfg.vocab_size
    long_prompt = _gen_tokens(V, B, S, dev)
    prompt = long_prompt[:, :P].contiguous()
    prefill = make_prefill_step(lm)

    ops.reset_launch_counts()
    long_last = prefill(w, {"tokens": long_prompt})
    torch.cuda.synchronize()
    prefill_counts = ops.launch_counts()
    t0 = time.perf_counter()
    for _ in range(SSM_PREFILL_REPS):
        prefill(w, {"tokens": long_prompt})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0) / SSM_PREFILL_REPS

    ops.reset_launch_counts()
    result = serve.generate(lm, w, prompt, SSM_TOKENS, temperature=1.0)
    serve_counts = ops.launch_counts()
    steps_run = P - 1 + SSM_TOKENS
    first, seq = result["first_logits"], result["tokens"]
    last = prefill(w, {"tokens": prompt})

    diff = (first.float() - last.float())
    rel_rms = float(diff.pow(2).mean().sqrt()
                    / last.float().pow(2).mean().sqrt())
    top1 = (first.argmax(-1) == last.argmax(-1)).float().mean()
    out = {
        "arch": cfg.name, "params": count_params(cfg), "batch": B,
        "prefill_len": S, "prompt_len": P, "new_tokens": SSM_TOKENS,
        "init_seconds": init_s, "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": B * S / (prefill_ms / 1e3),
        "prefill_launches": prefill_counts,
        "teacher_forced_ms_per_step": 1e3 * result["teacher_forced_seconds"]
        / (P - 1),
        "sampled_ms_per_token": 1e3 * result["sampled_seconds"] / SSM_TOKENS,
        "sampled_tokens_per_s": B * SSM_TOKENS / result["sampled_seconds"],
        "serve_launches": serve_counts, "serve_steps": steps_run,
        "prefill_vs_decode_logits": {
            "max_abs_err": float(diff.abs().max()), "rel_rms_err": rel_rms,
            "rel_rms_bound": LM_REL_RMS_MAX,
            "top1_agreement": float(top1),
            "logit_rms": float(last.float().pow(2).mean().sqrt())},
    }
    print("mamba2-370m serving:", json.dumps(out), flush=True)
    check(tuple(long_last.shape) == (B, V) and tuple(last.shape) == (B, V)
          and tuple(first.shape) == (B, V),
          f"logits have shapes {tuple(long_last.shape)}, "
          f"{tuple(last.shape)}, {tuple(first.shape)}")
    check(bool(torch.isfinite(long_last).all() and torch.isfinite(last).all()
               and torch.isfinite(first).all()),
          "a mamba2 prefill or decode logit is not finite")
    check(tuple(seq.shape) == (B, P + SSM_TOKENS)
          and bool(((seq >= 0) & (seq < V)).all()),
          f"tokens of shape {tuple(seq.shape)} or outside [0, {V})")
    check(torch.equal(seq[:, :P], prompt), "the prompt was not kept")
    check(rel_rms <= LM_REL_RMS_MAX,
          f"mamba2 prefill and teacher-forced decode logits at P-1 differ by "
          f"{rel_rms} (relative rms) > {LM_REL_RMS_MAX}")
    per_pass = cfg.num_layers + 1
    check(prefill_counts["ssd_scan"] == cfg.num_layers
          and prefill_counts["rmsnorm"] == per_pass,
          f"mamba2 prefill launched ssd_scan {prefill_counts['ssd_scan']} and "
          f"rmsnorm {prefill_counts['rmsnorm']} times, not {cfg.num_layers} "
          f"and {per_pass}")
    check(serve_counts["ssd_scan"] == 0
          and serve_counts["rmsnorm"] == per_pass * steps_run,
          f"mamba2 serving launched ssd_scan {serve_counts['ssd_scan']} and "
          f"rmsnorm {serve_counts['rmsnorm']} times over {steps_run} steps, "
          f"not 0 and {per_pass} per step")

    out["decode_breakdown"] = decode_breakdown(lm, w, prompt, 16)
    step = make_serve_step(lm)
    cache = lm.init_cache(B, P + SSM_TOKENS, device=dev)
    out["bounds"] = ssm_serving_bounds(cfg, w, cache, B, S)
    tok = prompt[:, :1]

    def serve_one():
        step(w, cache, tok, 0, torch.Generator().manual_seed(0))
    out["decode_breakdown"]["host_syncs_per_step"] = count_syncs(serve_one)
    out["prefill_host_syncs"] = count_syncs(
        lambda: prefill(w, {"tokens": long_prompt}))
    out["decode_profile"] = device_profile(serve_one, 8)
    out["prefill_profile"] = device_profile(
        lambda: prefill(w, {"tokens": long_prompt}), 2)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print("mamba2-370m breakdown:", json.dumps(
        {k: out[k] for k in ("decode_breakdown", "decode_profile",
                             "prefill_profile", "prefill_host_syncs",
                             "peak_mem_gb", "bounds")}), flush=True)
    return out


def run_ssm_f32_check(dev):
    """A full-width, SSM_F32_LAYERS-layer float32 mamba2 (params from seed 0
    on the card) through the kernels and through the plain versions on the
    card (``ops.SPECS`` pointed at them for the second run): the prefill's
    last logits at B = 4, P = 512, then SSM_F32_DECODE_STEPS decode steps of
    the prompt teacher-forced into a fresh cache, and that cache's state and
    conv tail.  In float32 the two differ by the kernels' own rounding: the
    bound is SSM_F32_REL_TOL of the largest logit (of the largest entry for
    a cache)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_F32_LAYERS,
                              dtype="float32")
    lm = LM(cfg)
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    prompt = _gen_tokens(cfg.vocab_size, SSM_BATCH, SSM_PROMPT, dev)
    prefill = make_prefill_step(lm)
    steps = SSM_F32_DECODE_STEPS

    def decode():
        cache = lm.init_cache(SSM_BATCH, steps, device=dev)
        logits = []
        for t in range(steps):
            lg, cache = lm.decode_step(w, prompt[:, t:t + 1], cache, t)
            logits.append(lg)
        return torch.stack(logits), cache["layers"]["p0"]["ssm"]

    ops.reset_launch_counts()
    got = prefill(w, {"tokens": prompt})
    prefill_counts = ops.launch_counts()
    ops.reset_launch_counts()
    got_dec, got_cache = decode()
    decode_counts = ops.launch_counts()
    saved = dict(ops.SPECS)
    try:
        for name in ("rmsnorm", "ssd_scan"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        want = prefill(w, {"tokens": prompt})
        want_dec, want_cache = decode()
    finally:
        ops.SPECS.update(saved)
    torch.cuda.synchronize()

    def rel(a, b):
        err = float((a - b).abs().max())
        return err, SSM_F32_REL_TOL * max(1.0, float(b.abs().max()))

    err, tol = rel(got, want)
    dec_err, dec_tol = rel(got_dec, want_dec)
    cache_errs = {k: rel(got_cache[k], want_cache[k]) for k in got_cache}
    out = {"layers": SSM_F32_LAYERS, "dtype": "float32", "max_abs_err": err,
           "tol": tol, "max_abs_logit": float(want.abs().max()),
           "launches": prefill_counts, "decode_steps": steps,
           "decode_max_abs_err": dec_err, "decode_tol": dec_tol,
           "cache_max_abs_err": {k: e for k, (e, _) in cache_errs.items()},
           "cache_tol": {k: t for k, (_, t) in cache_errs.items()},
           "decode_launches": decode_counts}
    print("mamba2 2-layer float32 kernels vs plain:", json.dumps(out),
          flush=True)
    check(bool(torch.isfinite(got).all() and torch.isfinite(got_dec).all()),
          "a float32 mamba2 logit is not finite")
    check(err <= tol, f"float32 mamba2 prefill through the kernels differs "
                      f"from the plain versions by {err} > {tol}")
    check(dec_err <= dec_tol, f"float32 mamba2 decode through the kernels "
                              f"differs from the plain versions by {dec_err}"
                              f" > {dec_tol}")
    for k, (e, t) in cache_errs.items():
        check(e <= t, f"float32 mamba2 decode cache {k} differs by {e} > {t}")
    L = SSM_F32_LAYERS
    check(prefill_counts["ssd_scan"] == L
          and prefill_counts["rmsnorm"] == L + 1,
          f"{L}-layer mamba2 prefill launched {prefill_counts}")
    check(decode_counts["ssd_scan"] == 0
          and decode_counts["rmsnorm"] == (L + 1) * steps,
          f"{steps} {L}-layer mamba2 decode steps launched {decode_counts}")
    return out


def ssm_kernel_rows(checks, timing, ssm):
    """The kernel-table row of ``ssd_scan``: its time and bound at
    mamba2-370m's prefill shape, and the launches of the mamba2 serving
    phases."""
    from repro_torch.kernels.ops import SPECS
    times, (bound_ms, bound_by), err = timing["ssd_scan"]
    by_phase = {"prefill": ssm["prefill_launches"]["ssd_scan"],
                "serve": ssm["serve_launches"]["ssd_scan"]}
    return [{
        "name": "ssd_scan", "route": SPECS["ssd_scan"].route,
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": SPECS["ssd_scan"].replaces,
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        "launches_per_prefill": by_phase["prefill"],
        "launches_per_decode_step": by_phase["serve"] / ssm["serve_steps"],
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["name"] == "ssd_scan"),
        "max_abs_err_main_shape": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "call_ms": times["call_ms"], "plain_call_ms": times["plain_call_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "shape": list(SSD_MAIN), "dtype": "bfloat16",
        "note": "its backward is autograd of the plain version, as the JAX "
                "package's custom_vjp differentiates its jnp reference; no "
                "TPU kernel"}]


def run_samplers(dev):
    """The kernels of slices 1-3 against their plain versions, then their
    main paths (NUTS logreg, the two HMMs, ChEES, MALA, RWM); returns their
    rows of the kernel table."""
    lf_checks, lf_timing = leapfrog_checks(dev)
    glm_checks_, glm_timing = glm_checks(dev)
    enum_checks_, enum_timings = enum_checks(dev)
    print("kernel checks:", json.dumps({"leapfrog_halfstep": lf_checks,
                                        "glm_potential_grad": glm_checks_,
                                        "enum_contract": enum_checks_}),
          flush=True)
    print("enum_contract timings:", json.dumps(
        {str(shape): t for shape, t in enum_timings.items()}), flush=True)
    ens_checks, ens_timing = ensemble_kernel_checks(dev)
    print("ensemble kernel checks:", json.dumps(ens_checks), flush=True)
    print("ensemble kernel timings:", json.dumps(
        {str(k): v for k, v in ens_timing.items()}), flush=True)

    from repro_torch.bench.models import covtype_data
    t0 = time.perf_counter()
    data = covtype_data(seed=0, n=N, d=D)
    data_s = time.perf_counter() - t0
    path, counts = run_main_path(dev, data, data_s)
    enum_path, enum_counts = run_enum_hmm(dev)
    run_hmm(dev)
    chees, chees_counts = run_chees(dev, data)
    mala, mala_counts, mala_mean = run_mrw(dev, data, "MALA")
    rwm, rwm_counts, _ = run_mrw(dev, data, "RWM",
                                 init_w=torch.from_numpy(mala_mean))

    from repro_torch.kernels.ops import SPECS
    kernels = []
    for name, source, timing, checks in (
            ("leapfrog_halfstep", "src/repro_torch/csrc/leapfrog.cu",
             lf_timing, lf_checks),
            ("glm_potential_grad", "src/repro_torch/csrc/glm_potential.cu",
             glm_timing, glm_checks_)):
        times, (bound_ms, bound_by), err = timing
        kernels.append({
            "name": name, "route": SPECS[name].route, "source": source,
            "replaces": SPECS[name].replaces, "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_abs_err_main_shape": err,
            "ms": times["ms"],
            "plain_ms": times["plain_ms"], "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launches_per_leapfrog": counts[name]
            / path["adaptive"]["num_leapfrog"]})
    main_t, large_t = enum_timings[ENUM_MAIN], enum_timings[ENUM_LARGE]
    for name, replaces, err_key, note in (
            ("enum_contract", SPECS["enum_contract"].replaces,
             "max_abs_err", None),
            ("enum_contract_bwd", None, "bwd_max_abs_err",
             "the backward of enum_contract: the JAX package has no TPU "
             "kernel for it, it differentiates ref.enum_contract")):
        times, (bound_ms, bound_by) = main_t[name]
        ltimes, (lbound_ms, lbound_by) = large_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/enum_contract.cu",
            "replaces": replaces, "launches": enum_counts[name],
            "max_abs_err": max(c[err_key] for c in enum_checks_),
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"],
            "launches_per_leapfrog": enum_counts[name]
            / enum_path["num_leapfrog"],
            "shape": main_t["shape"],
            "large": {"shape": large_t["shape"], "ms": ltimes["ms"],
                      "plain_ms": ltimes["plain_ms"],
                      "call_ms": ltimes["call_ms"],
                      "library_ms": ltimes["library_ms"],
                      "bound_ms": lbound_ms, "bound_by": lbound_by},
            **({"note": note} if note else {})})
    kernels += ensemble_kernel_rows(ens_checks, ens_timing, {
        "leapfrog_halfstep_batch": {"ChEES": (chees, chees_counts)},
        "mala_step": {"MALA": (mala, mala_counts), "RWM": (rwm, rwm_counts)}})
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build_s = _build.build_all(["leapfrog", "glm_potential",
                                "enum_contract", "leapfrog_batch",
                                "mala_step", "rmsnorm", "flash_attention",
                                "flash_attention_bwd", "softmax_xent",
                                "ssd_scan"])
    print("build seconds:", json.dumps(build_s), flush=True)
    phase_s = {}
    t0 = time.perf_counter()
    kernels = run_samplers(dev)
    phase_s["samplers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_checks, lm_timing = lm_kernel_checks(dev)
    print("LM kernel checks:", json.dumps(lm_checks), flush=True)
    print("LM kernel timings:", json.dumps(
        {str(k): v for k, v in lm_timing.items()}), flush=True)
    lm = run_lm(dev)
    torch.cuda.empty_cache()
    run_lm_f32_check(dev)
    torch.cuda.empty_cache()
    phase_s["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_checks, tr_timing = train_kernel_checks(dev)
    print("train kernel checks:", json.dumps(tr_checks), flush=True)
    print("train kernel timings:", json.dumps(tr_timing), flush=True)
    train = run_train(dev)
    torch.cuda.empty_cache()
    run_train_f32_check(dev)
    phase_s["train"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssm_checks, ssm_timing = ssm_kernel_checks(dev)
    print("ssm kernel checks:", json.dumps(ssm_checks), flush=True)
    print("ssm kernel timings:", json.dumps(ssm_timing), flush=True)
    ssm = run_ssm(dev)
    torch.cuda.empty_cache()
    run_ssm_f32_check(dev)
    phase_s["ssm"] = time.perf_counter() - t0
    kernels += lm_kernel_rows(lm_checks, lm_timing, lm, train, ssm)
    kernels += train_kernel_rows(tr_timing, tr_checks, train)
    kernels += ssm_kernel_rows(ssm_checks, ssm_timing, ssm)
    print("phase seconds:", json.dumps(phase_s), flush=True)
    print("wall seconds:", time.perf_counter() - t_start, flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
