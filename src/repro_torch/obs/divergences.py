"""Divergence forensics: where in parameter space do transitions blow up?

A divergence count tells you a run has a problem; it does not tell you
*where*.  This module keeps a bounded ring of divergent-transition records
(unconstrained position, energy, step size, iteration), captured at the
executor's chunk drain from the draws the chunk already collected.  Cost
discipline: the ``diverging`` mask comes to the host in the chunk's one
drain; positions are gathered on the device *only for divergent draws* and
copied in one more read, so a clean chunk adds no read and a dirty one one,
its size capped by the ring.

At the end of a run the executor attaches a per-dimension baseline
(mean/std over all collected draws, from moments each chunk reduced on the
device beside its drain) and the telemetry layer writes
``divergences.json`` next to the run's other artifacts.  The CLI turns that
into a localization report::

    python -m repro_torch.obs.divergences <run_dir>

ranking dimensions by how far the divergent positions sit from the bulk of
the posterior (offset in baseline-sigma units).  Exit codes: 0 on a
readable artifact (divergent or not), 2 when it is missing or unreadable.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from .metrics import host_tree
from .monitor import _combine

ARTIFACT_NAME = "divergences.json"


def _gather(leaf, idx):
    """Rows ``(c, t)`` of ``idx`` from a (chains, draws, ...) leaf, on the
    leaf's device: the indices go to a card through pinned memory without
    waiting for it."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)[idx[:, 0], idx[:, 1]]
    index = torch.from_numpy(np.ascontiguousarray(idx.T))
    if leaf.device.type == "cuda":
        index = index.pin_memory().to(leaf.device, non_blocking=True)
    return leaf[index[0], index[1]]


class DivergenceRing:
    """Bounded ring of divergent-transition records (most recent kept)."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self.total = 0          # every divergence seen, kept or not
        self.records = []       # bounded by capacity
        self.baseline = None    # {"mean": [...], "std": [...], "draws": n}
        self._moments = None    # (n, mean, M2) of the draws folded so far

    def fold(self, start: int, out, host_mask, phase: str = "sample",
             reads=None) -> int:
        """Record the divergent draws of one drained chunk.

        ``out`` is the chunk's collected draws (tensors on the device or
        host arrays, chain axis first), ``host_mask`` the already drained
        ``(chains, k)`` ``diverging`` mask, ``start`` the chunk's first
        absolute iteration.  The divergent rows of ``z``, the energy and
        the step size are gathered where they lie and copied in one read
        (``reads``, counted).  Returns the number of divergences in the
        chunk."""
        idx = np.argwhere(np.asarray(host_mask))
        if idx.size == 0:
            return 0
        cs, ts = idx[:, 0], idx[:, 1]
        energy_key = "energy" if "energy" in out else "potential_energy"
        keys = ["z", energy_key] + (["step_size"] if "step_size" in out
                                    else [])
        rows = host_tree({k: _gather(out[k], idx) for k in keys}, reads)
        z_rows = np.asarray(rows["z"], np.float64)
        energies = np.asarray(rows[energy_key], np.float64)
        steps = (np.asarray(rows["step_size"], np.float64)
                 if "step_size" in out else np.full(len(cs), np.nan))
        for j in range(len(cs)):
            self.records.append({
                "chain": int(cs[j]),
                "iteration": int(start + ts[j]),
                "phase": str(phase),
                "z": z_rows[j].ravel().tolist(),
                "energy": float(energies[j]),
                "energy_kind": energy_key,
                "step_size": float(steps[j]),
            })
        self.total += len(cs)
        if len(self.records) > self.capacity:
            self.records = self.records[-self.capacity:]
        return len(cs)

    def set_baseline(self, z) -> None:
        """Attach the per-dim posterior baseline from the full collected
        draws, ``z``: (chains, draws, ...) host array."""
        z = np.asarray(z, np.float64)
        flat = z.reshape(-1, int(np.prod(z.shape[2:])) if z.ndim > 2 else 1)
        self.baseline = {"mean": flat.mean(0).tolist(),
                         "std": flat.std(0).tolist(),
                         "draws": int(flat.shape[0])}

    def fold_moments(self, n: int, mean, m2) -> None:
        """Merge one chunk's per-dim ``(count, mean, M2)`` of the draws
        (Chan's update): the executor reduces each sampling chunk's draws
        on the device beside its drain, so the baseline costs no read of
        its own."""
        mean, m2 = np.asarray(mean, np.float64), np.asarray(m2, np.float64)
        self._moments = (int(n), mean, m2) if self._moments is None \
            else _combine(*self._moments, int(n), mean, m2)

    def set_baseline_from_moments(self) -> None:
        """Attach the baseline from the folded moments (population std, as
        :meth:`set_baseline`)."""
        n, mean, m2 = self._moments
        self.baseline = {"mean": mean.tolist(),
                         "std": np.sqrt(m2 / n).tolist(), "draws": int(n)}

    def to_json(self) -> dict:
        return {"capacity": self.capacity, "total": self.total,
                "num_kept": len(self.records), "records": self.records,
                "baseline": self.baseline}

    def write(self, directory: str) -> str:
        """Atomically write ``divergences.json`` into ``directory``."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, ARTIFACT_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        os.replace(tmp, path)
        return path


def load(path: str) -> dict:
    """Load a forensics artifact from a file or a run directory."""
    if os.path.isdir(path):
        path = os.path.join(path, ARTIFACT_NAME)
    with open(path) as f:
        return json.load(f)


def localize(data: dict, top: int = 10):
    """Rank dimensions by |divergent mean - baseline mean| / baseline std.

    Returns a list of ``(dim, offset_sigma, div_mean, base_mean, base_std)``
    sorted by descending |offset|; empty when there is nothing to rank
    (no kept records or no baseline)."""
    records = data.get("records") or []
    baseline = data.get("baseline")
    if not records or not baseline:
        return []
    z = np.asarray([r["z"] for r in records], np.float64)
    mean = np.asarray(baseline["mean"], np.float64)
    std = np.asarray(baseline["std"], np.float64)
    div_mean = z.mean(0)
    offset = (div_mean - mean) / np.where(std == 0, 1.0, std)
    order = np.argsort(-np.abs(offset))
    return [(int(d), float(offset[d]), float(div_mean[d]),
             float(mean[d]), float(std[d])) for d in order[:top]]


def report(data: dict, top: int = 10) -> str:
    """Human-readable forensics report for one artifact."""
    lines = [f"divergences: {data.get('total', 0)} total, "
             f"{data.get('num_kept', 0)} kept "
             f"(ring capacity {data.get('capacity', '?')})"]
    records = data.get("records") or []
    if not records:
        lines.append("no divergent transitions recorded.")
        return "\n".join(lines)
    its = [r["iteration"] for r in records]
    chains = sorted({r["chain"] for r in records})
    steps = np.asarray([r["step_size"] for r in records], np.float64)
    energies = np.asarray([r["energy"] for r in records], np.float64)
    lines.append(f"iterations {min(its)}..{max(its)} | chains {chains}")
    if np.isfinite(steps).any():
        lines.append(f"step size at divergence: "
                     f"median {np.nanmedian(steps):.4g}")
    if np.isfinite(energies).any():
        kind = records[0].get("energy_kind", "energy")
        lines.append(f"{kind} at divergence: "
                     f"median {np.nanmedian(energies):.4g}")
    ranked = localize(data, top=top)
    if not ranked:
        lines.append("(no baseline attached — cannot localize; rerun with "
                     "telemetry enabled)")
        return "\n".join(lines)
    lines.append("")
    lines.append("where divergent positions sit vs. the posterior bulk "
                 "(unconstrained space):")
    lines.append(f"{'dim':>6} {'offset':>10} {'div_mean':>12} "
                 f"{'base_mean':>12} {'base_std':>12}")
    for dim, off, dmean, bmean, bstd in ranked:
        lines.append(f"{dim:>6} {off:>9.2f}σ {dmean:>12.4g} "
                     f"{bmean:>12.4g} {bstd:>12.4g}")
    worst = ranked[0]
    lines.append("")
    lines.append(f"divergences concentrate at dim {worst[0]}: "
                 f"{abs(worst[1]):.1f} baseline sigmas "
                 f"{'below' if worst[1] < 0 else 'above'} the posterior "
                 "mean — reparameterize or lower step size there.")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    top = 10
    if "--top" in argv:
        i = argv.index("--top")
        top = int(argv[i + 1])
        del argv[i:i + 2]
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.divergences <run_dir|"
              "divergences.json> [--top N]", file=sys.stderr)
        return 2
    try:
        data = load(argv[0])
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: cannot read forensics artifact from {argv[0]}: {e}",
              file=sys.stderr)
        return 2
    print(report(data, top=top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
