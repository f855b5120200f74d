"""Time the GLM potential kernel against other builds of it on one card.

    PYTHONPATH=src python -m repro_torch.bench.glm_kernels [--parent DIR]
        [--builds SRC ...] [--out FILE]

Builds ``csrc/glm_potential.cu`` with ``-Xptxas -v`` (its registers and
spill by instantiation), and the sources given to ``--builds`` (other
versions with this tree's C interface), each run behind the package's
wrapper in a process of its own; with ``--parent``, the same source from
another checkout (a commit to compare with: before the chains kernel, a
one-chain kernel plus a fold kernel, called once per chain).  At the main
path's shape (``chip_smoke.N`` x ``chip_smoke.D``, bernoulli_logit with an
offset) each build is held against the float64 plain version (and a chains
build against its own 1-chain calls, bit for bit), then timed by CUDA-graph
replays between CUDA events (``chip_smoke.device_ms``) at C = 1, 8 and 16
chains a call: the parent's as C calls, one per chain (what the ensembles
launched before); in the order parent, this tree, the other builds, this
tree, parent; each time beside its bound, max(bytes, operations = n (4 d
+ 12) C).  Prints one JSON object and writes it to ``--out`` (default
``src/repro_torch/build/bench/glm_kernels.json``).  Needs a card and
``nvcc``.
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
from repro_torch.kernels.glm_potential import (  # noqa: E402
    glm_potential_grad_cuda, glm_potential_grad_ref)

OUT = _build.BUILD_DIR / "bench"
CHAINS = (1, 8, 16)
ITERS = 20


def ptxas_usage(src: Path, tag: str):
    """``nvcc -Xptxas -v`` of ``src``: registers, spill stores and shared
    bytes per kernel instantiation (mangled name)."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{src.stem}{tag}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", str(lib), str(src)], capture_output=True,
        text=True, timeout=600)
    cs.check(proc.returncode == 0, f"nvcc failed for {src}:\n{proc.stderr}")
    usage, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            usage[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return lib, usage


def parent_call(lib_path: Path):
    """The parent's one-chain export, allocated as its wrapper did."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.glm_potential_grad_f32
    fn.argtypes = ([ctypes.c_void_p] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.glm_potential_num_blocks.argtypes = [ctypes.c_longlong]
    lib.glm_potential_num_blocks.restype = ctypes.c_int

    def run(x, y, w, off):
        n, d = x.shape
        blocks = lib.glm_potential_num_blocks(n)
        part_nll = torch.empty(blocks, dtype=torch.float32, device=x.device)
        part_grad = torch.empty((blocks, d), dtype=torch.float32,
                                device=x.device)
        nll = torch.empty((), dtype=torch.float32, device=x.device)
        grad = torch.empty(d, dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), y.data_ptr(), off.data_ptr(), w.data_ptr(),
                1.0, 0, n, d, part_nll.data_ptr(), part_grad.data_ptr(),
                blocks, nll.data_ptr(), grad.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"parent GLM launch failed: cudaError {rc}")
        return nll, grad

    return run


def bound_ms(n, d, chains):
    nbytes = 4 * (n * d + 2 * n + 2 * chains * d + chains)
    return cs.bound(nbytes, n * (4 * d + 12) * chains, torch.float32)


def inputs(dev):
    n, d = cs.N, cs.D
    gen = torch.Generator().manual_seed(n + d)
    x = torch.randn((n, d), generator=gen).to(dev)
    w_all = (0.3 * torch.randn((max(CHAINS), d), generator=gen)).to(dev)
    off = (0.2 * torch.randn(n, generator=gen)).to(dev)
    y = (torch.rand(n, generator=gen) < 0.5).float().to(dev)
    return x, y, w_all, off


def run_build(lib_path: str):
    """In a process of its own: the build at ``lib_path`` (this tree's C
    interface) behind the package's wrapper, held against the float64
    plain version and its own 1-chain calls, then timed at each C."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build._LOADED["glm_potential"] = ctypes.CDLL(lib_path)
    x, y, w_all, off = inputs(dev)
    want = glm_potential_grad_ref(x, y, w_all.double(), off,
                                  compute_dtype=torch.float64)
    got = glm_potential_grad_cuda(x, y, w_all, off)
    singles = [glm_potential_grad_cuda(x, y, w_all[c], off)
               for c in range(max(CHAINS))]
    out = {"max_abs_err_vs_float64": max(
        float((got[0].double() - want[0]).abs().max()),
        float((got[1].double() - want[1]).abs().max())),
        "bit_identical_to_single_chain": all(
            torch.equal(got[0][c], v) and torch.equal(got[1][c], g)
            for c, (v, g) in enumerate(singles))}
    for chains in CHAINS:
        w = w_all[:chains].contiguous()
        ms = cs.device_ms(lambda: glm_potential_grad_cuda(x, y, w, off),
                          ITERS)
        b, by = bound_ms(cs.N, cs.D, chains)
        out[str(chains)] = {"ms": ms, "bound_ms": b, "bound_by": by}
    return out


def run_apart(tag, src: Path):
    lib, usage = ptxas_usage(src, tag)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.glm_kernels", "--run",
         str(lib)], capture_output=True, text=True, timeout=600)
    cs.check(proc.returncode == 0, f"{tag} failed:\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["usage"] = usage
    return out


def time_parent(parent, dev):
    x, y, w_all, off = inputs(dev)
    want = glm_potential_grad_ref(x, y, w_all.double(), off,
                                  compute_dtype=torch.float64)
    err = 0.0
    for c in range(max(CHAINS)):
        v, g = parent(x, y, w_all[c], off)
        err = max(err, abs(float(v) - float(want[0][c])),
                  float((g.double() - want[1][c]).abs().max()))
    out = {"max_abs_err_vs_float64": err}
    for chains in CHAINS:
        rows = [w_all[c] for c in range(chains)]

        def loop():
            for w in rows:
                parent(x, y, w, off)

        ms = cs.device_ms(loop, max(1, ITERS // chains))
        b, by = bound_ms(cs.N, cs.D, chains)
        out[str(chains)] = {"ms": ms, "bound_ms": b, "bound_by": by,
                            "launches": chains}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose csrc/glm_potential.cu (one chain "
                         "a launch) to compare")
    ap.add_argument("--builds", type=Path, nargs="*", default=[],
                    help="other sources with this tree's C interface")
    ap.add_argument("--out", type=Path, default=OUT / "glm_kernels.json")
    ap.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run is not None:
        print(json.dumps(run_build(args.run)))
        return 0
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": cs.card_line(), "shape": [cs.N, cs.D],
           "family": "bernoulli_logit", "runs": []}
    parent = None
    if args.parent is not None:
        lib, out["parent_usage"] = ptxas_usage(
            args.parent / "src" / "repro_torch" / "csrc"
            / "glm_potential.cu", "-parent")
        parent = parent_call(lib)
    this = _build.CSRC / "glm_potential.cu"
    others = [(f"build{i}", src) for i, src in enumerate(args.builds)]
    # in turns: parent, this tree, the other builds, this tree, parent
    order = ([("parent", None)] if parent else []) + [("this", this)] \
        + others + [("this", this)] + ([("parent", None)] if parent else [])
    for tag, src in order:
        res = time_parent(parent, dev) if src is None \
            else run_apart(tag, src)
        out["runs"].append({"build": tag, "source": None if src is None
                            else str(src), **res})
    text = json.dumps(out)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
