"""Time a checkpointed sampler run against the same run without
checkpoints, on one card.

    PYTHONPATH=src python -m repro_torch.bench.checkpoint_cost
        [--rounds 2] [--out FILE]

Runs ``MCMC(NUTS(logreg_model_glm), 24, 36, num_chains=4)`` (lockstep
NUTS) on the 581,012 x 54 CoverType-shaped logistic regression, the
geometry of ``chip_smoke.py``'s checkpoint phase: one warm-up run (the
process's first setup, not counted), then per round a run without
checkpoints, two with ``checkpoint_every=20`` into a temporary directory
and one without again, so drift on the card's host shows.  For each run it
keeps the wall and chain seconds; for each checkpointed run every
``checkpoint.save`` call's ms and bytes, the state writes and the samples
writes apart.  Every run's draws must be bit-identical to the first's.
Prints one JSON object and writes it to ``--out`` (default
``src/repro_torch/build/bench/checkpoint_cost.json``).  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from ..distributed import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "src" / "repro_torch" / "build" / "bench" / "checkpoint_cost.json"
WARMUP, DRAWS, CHAINS, EVERY = 24, 36, 4, 20


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def _timed_saves():
    """Wrap ``checkpoint.save`` (the executor calls it through the module):
    each call's directory, ms and bytes.  Returns ``(calls, undo)``."""
    real, calls = ckpt.save, []

    def save(tree, directory, **kwargs):
        t0 = time.perf_counter()
        real(tree, directory, **kwargs)
        ms = 1e3 * (time.perf_counter() - t0)
        calls.append({"dir": os.path.basename(directory), "ms": ms,
                      "bytes": sum(os.path.getsize(os.path.join(directory, f))
                                   for f in os.listdir(directory))})

    def undo():
        ckpt.save = real

    ckpt.save = save
    return calls, undo


def _run(data, checkpointed):
    from .models import logreg_model_glm
    from ..core.infer import MCMC, NUTS
    mcmc = MCMC(NUTS(logreg_model_glm), WARMUP, DRAWS, num_chains=CHAINS)
    root = tempfile.mkdtemp() if checkpointed else None
    calls, undo = _timed_saves()
    t0 = time.perf_counter()
    try:
        if checkpointed:
            mcmc.run(0, data["x"], y=data["y"], checkpoint_every=EVERY,
                     checkpoint_dir=os.path.join(root, "ck"))
        else:
            mcmc.run(0, data["x"], y=data["y"])
        wall = time.perf_counter() - t0
    finally:
        undo()
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    row = {"checkpointed": checkpointed, "wall_seconds": wall,
           "chain_seconds": mcmc.stats["chain_seconds"],
           "num_leapfrog": mcmc.stats["num_leapfrog"]}
    if checkpointed:
        row["state_write_ms"] = [c["ms"] for c in calls if c["dir"] == "state"]
        row["state_write_bytes"] = [c["bytes"] for c in calls
                                    if c["dir"] == "state"][-1]
        row["samples_write_ms"] = [c["ms"] for c in calls
                                   if c["dir"] != "state"]
    return mcmc, row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    from .models import covtype_data
    data = covtype_data(seed=0, n=581_012, d=54)
    first, _ = _run(data, False)  # the process's first setup: not counted
    runs = []
    for _ in range(args.rounds):
        for checkpointed in (False, True, True, False):
            mcmc, row = _run(data, checkpointed)
            row["bit_identical"] = all(
                torch.equal(mcmc._collected[k], first._collected[k])
                for k in first._collected)
            if not row["bit_identical"]:
                raise RuntimeError(f"a run differs from the first: {row}")
            runs.append(row)
    result = {"card": _card(), "geometry": {
        "num_warmup": WARMUP, "num_samples": DRAWS, "num_chains": CHAINS,
        "checkpoint_every": EVERY, "data": [581_012, 54]}, "runs": runs}
    for key in (False, True):
        chain = [r["chain_seconds"] for r in runs if r["checkpointed"] == key]
        result["mean_chain_seconds_" + ("checkpointed" if key
                                        else "plain")] = sum(chain) / len(chain)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
