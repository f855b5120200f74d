"""Compare builds of the two training-backward kernels on one card.

    PYTHONPATH=src python -m repro_torch.bench.bwd_kernels [--parent DIR]
        [--out FILE]

Builds ``csrc/flash_attention_bwd.cu`` once per tile choice of the bf16 dq
pass (a copy with its ``DQ_TILES_128``/``DQ_TILES_256`` rewritten) and
``csrc/rmsnorm.cu``, and, with ``--parent``, the same two sources from
another checkout (a commit to compare with).  For each build it holds the
bf16 dq pass and the rmsnorm backward against their plain versions, checks
that two calls give the same bits, times them at gemma-2b's training shapes
(and the dq pass at Qwen3-8B's prefill shape) as ``chip_smoke.py`` does,
splits each call's device time by kernel (``torch.profiler``) and reads the
dq kernels' registers, spill and HMMA count (``cuobjdump``); each build
in a process of its own.  Beside them, SDPA's and ``F.rms_norm``'s
backward at the same shapes.  Prints one JSON object and writes it to
``--out`` (default ``src/repro_torch/build/bench/bwd_kernels.json``, beside
the builds).  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fl  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref  # noqa: E402

OUT = _build.BUILD_DIR / "bench"
# (keys per tile, key groups) at head dims <= 128 and <= 256; "default" is
# the source's own choice
DQ_VARIANTS = {"default": None,
               "kt64_split2": ((64, 2), (64, 2)),
               "kt32_split1": ((32, 1), (32, 1)),
               "kt64_split1": ((64, 1), (64, 1))}
# bf16 check cases (B, S, H, K, dq, dv, causal): both exact instantiations,
# the guarded buckets, ragged S, head dims not a multiple of 8 or 16
DQ_CASES = [cs.ATTN_BWD_MAIN, cs.ATTN_MAIN, (1, 130, 4, 1, 256, 256, False),
            (1, 200, 4, 4, 128, 128, True), (1, 130, 4, 2, 192, 128, True),
            (2, 65, 4, 2, 64, 64, False), (1, 70, 2, 1, 36, 20, True),
            (3, 7, 2, 2, 32, 16, False)]
RMS_CASES = [cs.RMS_BWD_MAIN, (4096, 4096), (7, 96), (1000, 2048),
             (3 * 5, 4097), (65536, 128), (2, 10000)]


def build(src: Path, tag=""):
    """Start ``nvcc`` on ``src`` into OUT (``csrc/`` on the include path);
    returns (process, library)."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{src.stem}{tag}.so"
    cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o",
           str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def with_tiles(tiles, tag):
    """A copy of ``csrc/flash_attention_bwd.cu`` whose dq tiles are
    ``tiles`` ((keys, groups) up to head dim 128, then up to 256)."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for dim, (kt, ks) in zip((128, 256), tiles):
        src, n = re.subn(rf"#define DQ_TILES_{dim} .*",
                         f"#define DQ_TILES_{dim} {kt}, {ks}", src)
        cs.check(n == 1, f"DQ_TILES_{dim} not found")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"flash_attention_bwd{tag}.cu"
    path.write_text(src)
    return path


def finish(job):
    proc, lib = job
    out, _ = proc.communicate()
    cs.check(proc.returncode == 0, f"nvcc failed for {lib.name}:\n{out}")
    return lib


def run_apart(kind, tag, lib):
    """Bench one build in a process of its own: two loaded builds with a
    kernel of the same name and template arguments would share the CUDA
    runtime's entry for it (its shared-memory limit among them)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.bwd_kernels", "--run", kind,
         tag, str(lib)], capture_output=True, text=True, timeout=600)
    cs.check(proc.returncode == 0, f"{kind} {tag} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def dq_call(lib):
    fn = lib.flash_attention_dq_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

    def run(q, k, v, o, lse, do, causal):
        B, S, H, dq = q.shape
        K, dv = k.shape[2], v.shape[3]
        dqt = torch.empty_like(q)
        delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dqt.data_ptr(), B, S, H, K, dq, dv, dq ** -0.5, int(causal),
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"dq launch failed: cudaError {rc}")
        return dqt, delta
    return run


def rms_call(lib):
    fn = lib.rmsnorm_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]

    def run(x, w, g):
        rows, d = x.numel() // x.shape[-1], x.shape[-1]
        dx = torch.empty_like(x)
        # room for either partition: one partial per 8 rows, or 128
        part = torch.empty((max(-(-rows // 8), 128), d), dtype=torch.float32,
                           device=x.device)
        dw = torch.empty(d, dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
                part.data_ptr(), dw.data_ptr(), rows, d, 1e-6,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"rmsnorm_bwd launch failed: cudaError {rc}")
        return dx, dw
    return run


def dq_inputs(case, dev, seed):
    B, S, H, K, dq, dv, causal = case
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=gen).to(torch.bfloat16).to(dev)
                   for s in ((B, S, H, dq), (B, S, K, dq), (B, S, K, dv),
                             (B, S, H, dv)))
    o, lse = (t.contiguous() for t in fl.flash_attention_ref(q, k, v,
                                                              causal=causal))
    return q, k, v, o, lse, do, causal


def bench_dq(name, lib, path, dev):
    run = dq_call(lib)
    res = {"checks": []}
    for i, case in enumerate(DQ_CASES):
        args = dq_inputs(case, dev, 300 + i)
        (dq, delta), (dq2, _) = run(*args), run(*args)
        rdq, rdelta = fl.flash_attention_dq_ref(*args)
        ok, err, ratio = cs._bf16_close(dq, rdq)
        res["checks"].append({"case": list(case), "ok": ok, "max_abs_err": err,
                              "err_over_bound": ratio,
                              "bitwise_repeat": bool(torch.equal(dq, dq2))})
        if case in (cs.ATTN_BWD_MAIN, cs.ATTN_MAIN):
            key = "gemma" if case == cs.ATTN_BWD_MAIN else "qwen3"
            res[f"{key}_ms"] = cs.device_ms(lambda: run(*args), 5)
            if key == "gemma":
                res["gemma_split"] = cs.kernel_split(lambda: run(*args), 20)
        del args
    if name != "parent":  # the tensor-core kernel's resources
        res["usage"] = cs.kernel_usage(path, "dq_tc_kernel")
        res["at_dims"] = cs.kernel_at_dims(lib, "flash_attention_dq_bf16_info")
    return res


def bench_rms(lib, dev):
    run = rms_call(lib)
    res = {"checks": []}
    for i, shape in enumerate(RMS_CASES):
        gen = torch.Generator().manual_seed(200 + i)
        x, g = (torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
                for _ in range(2))
        w = (torch.rand(shape[-1], generator=gen) + 0.5).to(dev)
        (dx, dw), (dx2, dw2) = run(x, w, g), run(x, w, g)
        rdx, rdw = rmsnorm_bwd_ref(x, w, g)
        ok, err, _ = cs._bf16_close(dx, rdx)
        dw_err = float((dw - rdw).abs().max())
        res["checks"].append({
            "shape": list(shape), "dx_ok": ok, "dx_max_abs_err": err,
            "dw_rel_err": dw_err / max(1.0, float(rdw.abs().max())),
            "bitwise_repeat": bool(torch.equal(dx, dx2)
                                   and torch.equal(dw, dw2))})
        if shape == cs.RMS_BWD_MAIN:
            res["ms"] = cs.device_ms(lambda: run(x, w, g), 50)
            res["split"] = cs.kernel_split(lambda: run(x, w, g), 50)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose csrc/ to build and compare")
    ap.add_argument("--out", type=Path, default=OUT / "bwd_kernels.json",
                    help="where to write the JSON result")
    ap.add_argument("--run", nargs=3, metavar=("KIND", "TAG", "LIB"),
                    help="bench one built library (dq or rms) and print it")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    if args.run:
        kind, tag, lib = args.run
        cdll = ctypes.CDLL(lib)
        res = (bench_dq(tag, cdll, Path(lib), dev) if kind == "dq"
               else bench_rms(cdll, dev))
        print(json.dumps(res))
        return 0
    csrc = _build.CSRC
    jobs = {("dq", name): build(
        csrc / "flash_attention_bwd.cu" if tiles is None
        else with_tiles(tiles, "-" + name), "-" + name)
        for name, tiles in DQ_VARIANTS.items()}
    jobs["rms", "new"] = build(csrc / "rmsnorm.cu", "-new")
    if args.parent is not None:
        pcsrc = args.parent / "src" / "repro_torch" / "csrc"
        jobs["dq", "parent"] = build(pcsrc / "flash_attention_bwd.cu",
                                     "-parent")
        jobs["rms", "parent"] = build(pcsrc / "rmsnorm.cu", "-parent")
    libs = {key: finish(job) for key, job in jobs.items()}
    result = {"card": cs.card_line(), "dq": {}, "rmsnorm_bwd": {}}
    for (kind, tag), lib in libs.items():
        res = run_apart(kind, tag, lib)
        result["dq" if kind == "dq" else "rmsnorm_bwd"][tag] = res
        print(kind, tag, json.dumps(res), flush=True)
    q, k, v, _, _, do, causal = dq_inputs(cs.ATTN_BWD_MAIN, dev, 0)
    result["sdpa_backward_gemma_ms"] = cs.sdpa_backward_ms(q, k, v, do,
                                                           causal)
    d = cs.RMS_BWD_MAIN[-1]
    x = torch.randn(cs.RMS_BWD_MAIN, device=dev).to(torch.bfloat16)
    w = torch.rand(d, device=dev).to(torch.bfloat16) + 0.5
    result["rms_norm_backward_ms"] = cs.backward_device_ms(
        lambda a, b: torch.nn.functional.rms_norm(a, (d,), b, 1e-6),
        (x.requires_grad_(), w.requires_grad_()), torch.randn_like(x), 50)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
