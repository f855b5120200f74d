"""Compare builds of the bf16 ``ssd_scan`` and the ``rmsnorm`` forward on
one card.

    PYTHONPATH=src python -m repro_torch.bench.fwd_kernels [--parent DIR]
        [--out FILE]

Builds ``csrc/ssd_scan.cu`` once per tile choice of the tensor-core scan (a
copy with its ``SSD_TILES`` rewritten: 32 or 64 channels per CTA, 32 or 64
keys per tile, one or two key groups of 4 warps) and ``csrc/rmsnorm.cu``
once per shape of its forward's teams (``RMS_FWD_TILES``: the vectors a
thread holds, the rows a team has in flight), and, with ``--parent``, the
same two sources from another checkout (a commit to compare with).  For
each build it holds the bf16 scan (``chip_smoke.SSD_SHAPES``, without
``D``, with ``D``, with ``D`` and ``h0``) and the rmsnorm forward
(``chip_smoke.RMS_SHAPES``, float32 and bf16) against their plain versions
with ``chip_smoke.py``'s bounds, times the scan at mamba2-370m's prefill
shape and the rmsnorm forward at ``RMS_TIMED``, warm and (at the main
shape) cold, as ``chip_smoke.py`` does, and reads the kernels' registers,
spill and HMMA count (``cuobjdump``); each build in a process of its own,
in the order parent, this tree, the variants, this tree, parent.  Beside
them, ``F.rms_norm`` warm and cold.  Prints one JSON object and writes it
to ``--out`` (default ``src/repro_torch/build/bench/fwd_kernels.json``).
Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.bench.bwd_kernels import build, finish  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: E402

OUT = _build.BUILD_DIR / "bench"
# (channels per CTA, keys per tile, key groups of 4 warps) of the n <= 128
# instantiations; "default" is the source's own choice
SSD_VARIANTS = {"default": None, "pb32_kt64_kg1": (32, 64, 1),
                "pb32_kt64_kg2": (32, 64, 2), "pb64_kt64_kg1": (64, 64, 1),
                "pb64_kt64_kg2": (64, 64, 2), "pb32_kt32_kg1": (32, 32, 1),
                "pb32_kt32_kg2": (32, 32, 2)}
# (16-byte vectors a thread holds, rows a team has in flight) of the
# rmsnorm forward
RMS_VARIANTS = {"default": None, "nv4_rb2": (4, 2), "nv4_rb4": (4, 4),
                "nv8_rb2": (8, 2), "nv2_rb4": (2, 4), "nv4_rb1": (4, 1)}
RUN = "--run"


def with_tiles(name, macro, tiles, tag):
    """A copy of ``csrc/<name>.cu`` whose ``macro`` is ``tiles``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    src, n = re.subn(rf"#define {macro} .*",
                     f"#define {macro} " + ", ".join(map(str, tiles)), src)
    cs.check(n == 1, f"{macro} not found")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}{tag}.cu"
    path.write_text(src)
    return path


def run_apart(kind, tag, lib):
    """Bench one build in a process of its own (two loaded builds with a
    kernel of one name and template arguments would share the CUDA
    runtime's entry for it)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.fwd_kernels", RUN, kind,
         tag, str(lib)], capture_output=True, text=True, timeout=600)
    cs.check(proc.returncode == 0, f"{kind} {tag} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def scan_call(lib):
    """``ssd_scan_cuda``'s launch, on the bf16 export of ``lib``."""
    fn = lib.ssd_scan_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, dt, A, B, C, chunk, D=None, h0=None):
        b, l, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        y = torch.empty_like(x)
        st = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), None if D is None else D.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                st.data_ptr(), b, l, h, p, g, n, chunk, x.stride(0),
                x.stride(1), B.stride(0), B.stride(1), C.stride(0),
                C.stride(1), torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"ssd_scan launch failed: cudaError {rc}")
        return y, st
    return run


def rms_call(lib):
    """``rmsnorm_cuda``'s launch, on the exports of ``lib``."""
    fns = {}
    for dtype, name in ((torch.float32, "rmsnorm_fwd_f32"),
                        (torch.bfloat16, "rmsnorm_fwd_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn

    def run(x, w):
        d = x.shape[-1]
        out = torch.empty_like(x)
        rc = fns[x.dtype](x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          x.numel() // d, d, 1e-6,
                          torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"rmsnorm launch failed: cudaError {rc}")
        return out
    return run


def bench_scan(name, lib, path, dev):
    run = scan_call(lib)
    res = {"checks": []}
    for seed, shape in enumerate(cs.SSD_SHAPES):
        b, l, h, p, g, n, chunk = shape
        x, dt, A, B, C, D, h0 = cs._ssd_inputs(b, l, h, p, g, n,
                                               torch.bfloat16, dev, seed)
        for label, kw in (("", {}), ("D", {"D": D}),
                          ("D,h0", {"D": D, "h0": h0})):
            y, st = run(x, dt, A, B, C, chunk, **kw)
            ry, rst = ssd_scan_ref(x, dt, A, B, C, chunk=chunk, **kw)
            ok, err, ratio = cs._bf16_close(y, ry)
            st_rel = float((st - rst).abs().max()) / max(
                1.0, float(rst.abs().max()))
            res["checks"].append({
                "shape": list(shape), "operands": label,
                "ok": ok and st_rel <= 1e-4, "y_max_abs_err": err,
                "y_err_over_bound": ratio, "state_rel_err": st_rel})
        if shape == cs.SSD_MAIN:
            res["ms"] = cs.device_ms(lambda: run(x, dt, A, B, C, chunk, D=D),
                                     5)
            res["achieved_tflops"] = cs.ssd_work(
                *shape, torch.bfloat16)[1] / res["ms"] / 1e9
    if name != "parent":  # the tensor-core kernel's resources
        res["usage"] = cs.kernel_usage(path, "ssd_tc_kernel")
        res["at_dims"] = cs.kernel_at_dims(lib, "ssd_scan_bf16_info",
                                           ((64, 128), (64, 16), (64, 256)))
    return res


def bench_rms(lib, path, dev):
    run = rms_call(lib)
    res = {"checks": [], "ms": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(cs.RMS_SHAPES):
            gen = torch.Generator().manual_seed(seed)
            x = torch.randn(shape, generator=gen).to(dtype).to(dev)
            w = (torch.rand(shape[-1], generator=gen) + 0.5).to(dev)
            got, want = run(x, w), rmsnorm_ref(x, w)
            if dtype == torch.float32:
                err = float((got - want).abs().max())
                ok = err <= 2e-5
            else:
                ok, err, _ = cs._bf16_close(got, want)
            res["checks"].append({"shape": list(shape), "dtype": str(dtype),
                                  "ok": ok, "max_abs_err": err})
            if dtype == torch.bfloat16 and shape in cs.RMS_TIMED:
                t = {"ms": cs.device_ms(lambda: run(x, w), 100)}
                if shape == cs.RMS_TIMED[0]:
                    t["cold_ms"] = cs.cold_device_ms(lambda a: run(a, w), x,
                                                     100)
                res["ms"][str(list(shape))] = t
    res["usage"] = cs.kernel_usage(path, "rmsnorm_fwd_kernel")
    return res


def library_rms(dev):
    """``F.rms_norm`` at ``RMS_TIMED`` in bf16, warm, and cold at the main
    shape; beside each, the bound."""
    out = {}
    for shape in cs.RMS_TIMED:
        d = shape[-1]
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        w = (torch.rand(d, device=dev) + 0.5).to(torch.bfloat16)
        t = {"ms": cs.device_ms(
            lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6), 100),
             "bound_ms": cs.rmsnorm_bound(math.prod(shape[:-1]), d,
                                          torch.bfloat16)[0]}
        if shape == cs.RMS_TIMED[0]:
            t["cold_ms"] = cs.cold_device_ms(
                lambda a: torch.nn.functional.rms_norm(a, (d,), w, 1e-6), x,
                100)
        out[str(list(shape))] = t
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose csrc/ to build and compare")
    ap.add_argument("--out", type=Path, default=OUT / "fwd_kernels.json",
                    help="where to write the JSON result")
    ap.add_argument(RUN, nargs=3, metavar=("KIND", "TAG", "LIB"),
                    help="bench one built library (scan or rms) and print it")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    if args.run:
        kind, tag, lib = args.run
        cdll = ctypes.CDLL(lib)
        res = (bench_scan(tag, cdll, Path(lib), dev) if kind == "scan"
               else bench_rms(cdll, Path(lib), dev))
        print(json.dumps(res))
        return 0
    csrc = _build.CSRC
    jobs = {}
    for kind, src, macro, variants in (
            ("scan", "ssd_scan", "SSD_TILES", SSD_VARIANTS),
            ("rms", "rmsnorm", "RMS_FWD_TILES", RMS_VARIANTS)):
        for name, tiles in variants.items():
            jobs[kind, name] = build(
                csrc / f"{src}.cu" if tiles is None
                else with_tiles(src, macro, tiles, "-" + name), "-" + name)
    if args.parent is not None:
        pcsrc = args.parent / "src" / "repro_torch" / "csrc"
        jobs["scan", "parent"] = build(pcsrc / "ssd_scan.cu", "-parent")
        jobs["rms", "parent"] = build(pcsrc / "rmsnorm.cu", "-parent")
    libs = {key: finish(job) for key, job in jobs.items()}
    # in turns: parent, this tree, the variants, this tree again, parent
    order = [k for k in (("scan", "parent"), ("rms", "parent")) if k in libs]
    order += [("scan", "default"), ("rms", "default")]
    order += [("scan", name) for name in SSD_VARIANTS if name != "default"]
    order += [("rms", name) for name in RMS_VARIANTS if name != "default"]
    order += [("scan", "default"), ("rms", "default")]
    order += [k for k in (("scan", "parent"), ("rms", "parent")) if k in libs]
    result = {"card": cs.card_line(), "ssd_scan": {}, "rmsnorm": {}}
    for kind, tag in order:
        res = run_apart(kind, tag, libs[kind, tag])
        result["ssd_scan" if kind == "scan" else "rmsnorm"].setdefault(
            tag, []).append(res)
        print(kind, tag, json.dumps(res), flush=True)
    result["rms_norm_library"] = library_rms(dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
