"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``) and build
   the hand-written kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at ragged ones, and time kernel and plain version
   with CUDA events (``enum_contract`` also against ``torch.logsumexp``, the
   library yardstick, and at a large shape; the batch leapfrog and the
   MALA/RWM proposal also at (64, 1,000,003)).
3. Drive the main paths through the user's entry points, each with every
   kernel launch counter set to 0 just before and read just after:
   ``MCMC(NUTS(logreg_model_glm), 100, 100).run(...)`` on 581,012 x 54
   CoverType-shaped data made from a seed, then the paper's fixed-step
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
4. Print one ``{"kernels": [...]}`` line, then the result line
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
FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    build_s = _build.build_all(["leapfrog", "glm_potential",
                                "enum_contract", "leapfrog_batch",
                                "mala_step"])
    print("build seconds:", json.dumps(build_s), flush=True)

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
    print("wall seconds:", time.perf_counter() - t_start, flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
