"""Per-run manifest: the durable record of what a run was.

One ``run_manifest.json`` lives next to the checkpoint directories (or
wherever ``Telemetry(dir=...)`` points) and accumulates *sessions*: the
original launch plus every resume appends a session with its own
environment snapshot (the card, its power limit and the versions may change
across a resume), chunk schedule, span timings and final diagnostics.
Run-level facts that must survive a resume (the cumulative divergence
count, the kernel setup hash, the sampling geometry) live at the top level.

Writes are atomic (tmp file + ``os.replace``) and use plain ``json``, never
``repro_torch.distributed.checkpoint.save``: the manifest is a sidecar, and
the kill tests count checkpoint ``save`` calls to define kill points, so
telemetry must not shift them.

Schema: ``manifest_schema.json`` in this package;
``python -m repro_torch.obs.validate`` checks a written manifest.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time

import torch

MANIFEST_NAME = "run_manifest.json"
SCHEMA_VERSION = 1

_POWER_LIMIT = []  # the card's power limit, read once per process


def _git_rev(cwd=None):
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except Exception:
        return None


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine() or None


def power_limit_w():
    """The first card's power limit in watts, from ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` (read once per
    process), or None where that fails."""
    if not _POWER_LIMIT:
        value = None
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=10)
            if out.returncode == 0 and out.stdout.strip():
                field = out.stdout.strip().splitlines()[0].rsplit(",", 1)[1]
                value = float(field.strip().split()[0])
        except Exception:
            value = None
        _POWER_LIMIT.append(value)
    return _POWER_LIMIT[0]


def collect_environment() -> dict:
    """Environment snapshot for one session: versions, devices, host."""
    cuda = torch.cuda.is_available()
    return {
        "git_rev": _git_rev(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 1,
        "power_limit_w": power_limit_w() if cuda else None,
        "cpu_model": _cpu_model(),
        "python_version": platform.python_version(),
        "hostname": platform.node(),
    }


class RunManifest:
    """The mutable, repeatedly flushed run record.

    Lifecycle per ``MCMC.run``: :meth:`begin_session` (appends a session;
    on ``resume=True`` it appends to the *existing* file, keeping earlier
    sessions), mutate via :meth:`session` / :meth:`set_divergences`,
    :meth:`finish_session` with final diagnostics.  Every mutator that
    matters flushes atomically, so a kill at any point leaves a parseable
    manifest describing everything up to the last completed chunk.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.data = None  # populated by begin_session

    # -- lifecycle ----------------------------------------------------------
    def begin_session(self, *, run_config: dict, resume: bool = False,
                      resumed_at=None) -> dict:
        existing = self._load() if resume else None
        if existing is None:
            self.data = {
                "schema_version": SCHEMA_VERSION,
                "created_unix": time.time(),
                "run": dict(run_config),
                "divergences": 0,
                "sessions": [],
            }
        else:
            self.data = existing
            # the executor checks the checkpoint's geometry (a hard error);
            # the manifest records what it saw
            self.data["run"] = dict(run_config)
        session = {
            "started_unix": time.time(),
            "resume": bool(resume),
            "resumed_at_iteration": (int(resumed_at)
                                     if resumed_at is not None else None),
            "environment": collect_environment(),
            "chunk_schedule": [],
            "spans": [],
            "counters": {},
            "final": None,
        }
        self.data["sessions"].append(session)
        self.flush()
        return session

    def session(self) -> dict:
        return self.data["sessions"][-1]

    def record_chunk(self, start: int, end: int, phase: str) -> None:
        self.session()["chunk_schedule"].append(
            [int(start), int(end), str(phase)])

    def record_span(self, record) -> None:
        self.session()["spans"].append(record.to_event())

    def set_divergences(self, n: int) -> None:
        self.data["divergences"] = int(n)

    @property
    def divergences(self) -> int:
        return int(self.data["divergences"]) if self.data else 0

    def finish_session(self, *, counters: dict, final: dict) -> None:
        self.session()["counters"] = {k: int(v) for k, v in counters.items()}
        self.session()["final"] = final
        self.flush()

    # -- persistence --------------------------------------------------------
    def _load(self):
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return data if isinstance(data, dict) and "sessions" in data else None

    @classmethod
    def peek(cls, path: str):
        """Read-only load."""
        m = cls(path)
        m.data = m._load()
        return m if m.data is not None else None

    def flush(self) -> None:
        from .sinks import _jsonable
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_jsonable(self.data), f, indent=1)
        os.replace(tmp, self.path)
