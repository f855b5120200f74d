"""Time a sampler run with telemetry against the same run without it, on
one card.

    PYTHONPATH=src python -m repro_torch.bench.obs_cost
        [--rounds 2] [--out FILE]

Runs ``MCMC(NUTS(logreg_model_glm), 24, 36, num_chains=4)`` (lockstep
NUTS) on the 581,012 x 54 CoverType-shaped logistic regression in chunks of
20, the geometry of ``chip_smoke.py``'s obs phase: one warm-up run (the
process's first setup, not counted), then per round a run without
telemetry, two with ``telemetry=obs.Telemetry()`` (metrics, events in
memory, forensics) and one without again, so drift on the card's host
shows.  For each run it keeps the chain seconds, the lockstep leapfrogs,
ms a lockstep leapfrog and the host syncs.  Every run's draws must be
bit-identical to the first's.  Prints one JSON object and writes it to
``--out`` (default ``src/repro_torch/build/bench/obs_cost.json``).  Needs
a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "src" / "repro_torch" / "build" / "bench" / "obs_cost.json"
WARMUP, DRAWS, CHAINS, EVERY = 24, 36, 4, 20


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def _run(data, observed):
    from .. import obs
    from .models import logreg_model_glm
    from ..core.infer import MCMC, NUTS
    mcmc = MCMC(NUTS(logreg_model_glm), WARMUP, DRAWS, num_chains=CHAINS,
                telemetry=obs.Telemetry() if observed else None)
    mcmc.run(0, data["x"], y=data["y"], checkpoint_every=EVERY)
    stats = mcmc.stats
    return mcmc, {"telemetry": observed,
                  "chain_seconds": stats["chain_seconds"],
                  "lockstep_leapfrogs": stats["lockstep_leapfrogs"],
                  "ms_per_lockstep_leapfrog": 1e3 * stats["chain_seconds"]
                  / stats["lockstep_leapfrogs"],
                  "host_syncs": stats["host_syncs"]}


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
        for observed in (False, True, True, False):
            mcmc, row = _run(data, observed)
            row["bit_identical"] = all(
                torch.equal(mcmc._collected[k], first._collected[k])
                for k in first._collected)
            if not row["bit_identical"]:
                raise RuntimeError(f"a run differs from the first: {row}")
            runs.append(row)
    result = {"card": _card(), "geometry": {
        "num_warmup": WARMUP, "num_samples": DRAWS, "num_chains": CHAINS,
        "checkpoint_every": EVERY, "data": [581_012, 54]}, "runs": runs}
    for key, name in ((False, "off"), (True, "on")):
        ms = sorted(r["ms_per_lockstep_leapfrog"] for r in runs
                    if r["telemetry"] == key)
        result[f"ms_per_lockstep_leapfrog_{name}"] = ms
        result[f"host_syncs_{name}"] = sorted(
            {r["host_syncs"] for r in runs if r["telemetry"] == key})
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
