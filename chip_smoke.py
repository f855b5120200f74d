"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``) and build
   the hand-written kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones, and time kernel and plain version
   with CUDA events.
3. Drive the main path through the user's entry points:
   ``MCMC(NUTS(logreg_model_glm), 100, 100).run(...)`` on 581,012 x 54
   CoverType-shaped data made from a seed, with every kernel launch counter
   set to 0 just before and read just after; then the paper's fixed-step
   configuration (0 warmup, 40 draws, step 0.0015, no adaptation).
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


def profile_transitions(mcmc, num):
    """Device busy share and device time per leapfrog over ``num`` more
    sampling transitions of the adapted chain, under ``torch.profiler``.
    The profiler adds host cost, so its wall time is not the run's."""
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
            leapfrogs += state.num_steps
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


def run_main_path(dev):
    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    data = covtype_data(seed=0, n=N, d=D)
    data_s = time.perf_counter() - t0
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
    for name, launches in counts.items():
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_s = _build.build_all(["leapfrog", "glm_potential"])
    print("build seconds:", json.dumps(build_s), flush=True)

    lf_checks, lf_timing = leapfrog_checks(dev)
    glm_checks_, glm_timing = glm_checks(dev)
    print("kernel checks:", json.dumps({"leapfrog_halfstep": lf_checks,
                                        "glm_potential_grad": glm_checks_}),
          flush=True)
    path, counts = run_main_path(dev)

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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
