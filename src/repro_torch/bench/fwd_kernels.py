"""Compare builds of the bf16 ``ssd_scan``, the ``rmsnorm`` forward and the
bf16 ``softmax_xent`` kernels on one card.

    PYTHONPATH=src python -m repro_torch.bench.fwd_kernels [--parent DIR]
        [--kinds scan,rms,xent] [--out FILE]

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
them, ``F.rms_norm`` warm and cold.  ``xent`` builds ``csrc/softmax_xent.cu``
once per tile choice of its bf16 kernels (``XENT_TILES``: vocab columns per
tile, depth per stage, stages) and from ``--parent``; each build holds the
bf16 forward (``chip_smoke.XENT_SHAPES``, both weight layouts) within 1e-4
of the plain version and, where it has the dlogits kernel, the bf16
backward's dx and dw within one bf16 step of the plain float32 backward,
then times at gemma-2b's microbatch (``chip_smoke.XENT_MAIN``) the forward,
the backward (the parent's: the plain backward it ran) and the dlogits
kernel alone.  ``--kinds`` picks the kinds (default all).  Prints one JSON
object and writes it to ``--out`` (default
``src/repro_torch/build/bench/fwd_kernels.json``).  Needs a card and
``nvcc``.
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
from repro_torch.kernels import softmax_xent as xe  # noqa: E402
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
# (vocab columns per tile, depth per stage, stages) of the bf16 xent kernels
XENT_VARIANTS = {"default": None, "bv128_ks32_st4": (128, 32, 4),
                 "bv256_ks64_st3": (256, 64, 3)}
KINDS = {"scan": ("ssd_scan", "SSD_TILES", SSD_VARIANTS, "ssd_scan"),
         "rms": ("rmsnorm", "RMS_FWD_TILES", RMS_VARIANTS, "rmsnorm"),
         "xent": ("softmax_xent", "XENT_TILES", XENT_VARIANTS,
                  "softmax_xent")}
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


def parent_xent_fwd(lib):
    """The parent's bf16 forward: its export, split as its wrapper split
    (128 x 128 tiles, two waves of two CTAs on 132 SMs)."""
    fn = lib.softmax_xent_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, w, labels, zlw):
        T, d = x.shape
        V = w.shape[1]
        tiles = -(-V // 128)
        per = -(-tiles // min(tiles, max(1, -(-528 // -(-T // 128)))))
        nsplit = -(-tiles // per)
        out = torch.empty((3, T), dtype=torch.float32, device=x.device)
        part = torch.empty((3, nsplit, T), dtype=torch.float32,
                           device=x.device)
        rc = fn(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                part.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), T, d, V, xe._layout(w), nsplit, per, zlw,
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"softmax_xent launch failed: cudaError {rc}")
        return out[0], out[1], out[2]
    return run


def bench_xent(name, lib, path, dev):
    """One build: the forward's and (this tree's builds) the backward's
    checks, then the times at ``XENT_MAIN``; the backward's incoming
    gradients are U(0.5, 1.5) per row, as in ``chip_smoke.py``."""
    parent = name == "parent"
    if not parent:  # the package's wrappers launch this build
        _build._LOADED["softmax_xent"] = lib
    fwd = parent_xent_fwd(lib) if parent else xe.softmax_xent_cuda
    res = {"checks": []}
    for seed, (T, d, V, tied) in enumerate(cs.XENT_SHAPES):
        x, w, labels = cs._xent_inputs(T, d, V, tied, torch.bfloat16,
                                       400 + seed, dev)
        got, again = fwd(x, w, labels, 1e-4), fwd(x, w, labels, 1e-4)
        want = xe.softmax_xent_ref(x, w, labels, 1e-4)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check = {"shape": [T, d, V], "tied": tied, "max_abs_err": err,
                 "ok": err <= 1e-4, "bitwise_repeat": all(
                     torch.equal(a, b) for a, b in zip(got, again))}
        lse = want[2]
        gce, gzl = cs.xent_grads(T, dev, seed)
        if not parent:
            check.update(cs.xent_bwd_case(x, w, labels, lse, gce, gzl))
            check["ok"] = check["ok"] and check["dx_ok"] and check["dw_ok"]
        res["checks"].append(check)
        if (T, d, V, tied) == cs.XENT_MAIN:
            res["fwd_ms"] = cs.device_ms(lambda: fwd(x, w, labels, 1e-4), 3)
            bwd = xe.softmax_xent_bwd if parent else xe.softmax_xent_bwd_cuda
            res["bwd_ms"] = cs.device_ms(
                lambda: bwd(x, w, labels, lse, gce, gzl, 1e-4), 2)
            if not parent:
                res["dlogits_ms"] = cs.xent_dlogits_ms(x, w, labels, lse, gce,
                                                       gzl, 1e-4, 3)
        del x, w, labels, got, again, want
        torch.cuda.empty_cache()
    if not parent:  # the tensor-core kernels' resources
        res["usage"] = {**cs.kernel_usage(path, "xent_fwd_tc_kernel"),
                        **cs.kernel_usage(path, "dlogits_tc_kernel")}
        res["at_dims"] = cs.kernel_at_dims(
            lib, "softmax_xent_bf16_info", cs.XENT_INFO_DIMS)
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
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated kinds to bench (scan, rms, xent)")
    ap.add_argument(RUN, nargs=3, metavar=("KIND", "TAG", "LIB"),
                    help="bench one built library (scan, rms or xent) and "
                         "print it")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.run:
        kind, tag, lib = args.run
        cdll = ctypes.CDLL(lib)
        bench = {"scan": lambda: bench_scan(tag, cdll, Path(lib), dev),
                 "rms": lambda: bench_rms(cdll, Path(lib), dev),
                 "xent": lambda: bench_xent(tag, cdll, Path(lib), dev)}
        print(json.dumps(bench[kind]()))
        return 0
    kinds = args.kinds.split(",")
    csrc = _build.CSRC
    jobs = {}
    for kind in kinds:
        src, macro, variants, _ = KINDS[kind]
        for name, tiles in variants.items():
            jobs[kind, name] = build(
                csrc / f"{src}.cu" if tiles is None
                else with_tiles(src, macro, tiles, "-" + name), "-" + name)
        if args.parent is not None:
            jobs[kind, "parent"] = build(
                args.parent / "src" / "repro_torch" / "csrc" / f"{src}.cu",
                "-parent")
    libs = {key: finish(job) for key, job in jobs.items()}
    # in turns: parent, this tree, the variants, this tree again, parent
    parents = [(k, "parent") for k in kinds if (k, "parent") in libs]
    order = parents + [(k, "default") for k in kinds]
    order += [(k, name) for k in kinds for name in KINDS[k][2]
              if name != "default"]
    order += [(k, "default") for k in kinds] + parents
    result = {"card": cs.card_line()}
    for kind, tag in order:
        res = run_apart(kind, tag, libs[kind, tag])
        result.setdefault(KINDS[kind][3], {}).setdefault(tag, []).append(res)
        print(kind, tag, json.dumps(res), flush=True)
    if "rms" in kinds:
        result["rms_norm_library"] = library_rms(dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
