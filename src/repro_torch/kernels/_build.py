"""Build the hand-written CUDA kernels with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and compiles
on its own into ``build/lib<name>-<hash>.so`` under this package (the
directory is listed in ``.gitignore``).  The hash is of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a stale library is never loaded.
A build takes a few seconds; :func:`build_all` starts one ``nvcc`` per
source at once.  Nothing is built at import: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def loads() -> int:
    """Libraries loaded (built first where needed) in this process: each
    is one-time work at a kernel's first launch."""
    return len(_LOADED)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "csrc/ at first use and need the CUDA toolkit (nvcc on PATH or "
        "under /usr/local/cuda)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start compiling ``name`` unless its library exists; returns the
    process (or None) and the target path."""
    target = library_path(name)
    if target.exists():
        return None, target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), target


def _finish(name: str, started, target: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a reader never sees half a library


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Build every named kernel in parallel (one ``nvcc`` each) and return
    the seconds from the start until each library was in place."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    seconds = {}
    for name, (job, target) in started.items():
        _finish(name, job, target)
        seconds[name] = time.perf_counter() - t0
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        started, target = _start(name)
        _finish(name, started, target)
        lib = ctypes.CDLL(str(target))
        _LOADED[name] = lib
    return lib
