"""Time the sampler paths of two checkouts on one card, in turns.

    PYTHONPATH=src python -m repro_torch.bench.sampler_steps --parent DIR
        [--phases NUTS,HMM,ChEES,MRW] [--out FILE]

Runs each checkout's own ``chip_smoke.py`` sampler phases in a process of
its own (each builds its kernels from its own ``csrc/``): NUTS on the
581,012 x 54 logistic regression (``run_main_path``: 100 + 100, profiled
over 20 more transitions, then the fixed-step configuration), the
enumerated and the semi-supervised HMM (``run_enum_hmm``, ``run_hmm``),
ChEES with 8 chains (``run_chees``: 300 + 1500, profiled over 20 more
transitions), then MALA and RWM with 16 chains (``run_mrw``: 500 + 500
each, profiled over 20 more iterations), with every gate of that
checkout; ``--phases`` picks some of them.  The order is
parent, this tree, this tree, parent, so drift on the card shows.  For
each run it keeps ms a leapfrog or iteration, device kernels, busy ms and
busy share a leapfrog or iteration (``torch.profiler``), host syncs and
the kernels' launches.  Prints one JSON object and writes it to ``--out`` (default
``src/repro_torch/build/bench/sampler_steps.json``).  Needs a card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
OUT = ROOT / "src" / "repro_torch" / "build" / "bench" / "sampler_steps.json"

# run inside a checkout: its chip_smoke.py puts its own src/ first
CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from repro_torch.bench.models import covtype_data
phases = sys.argv[1].split(",")
dev = torch.device("cuda")
data = covtype_data(seed=0, n=c.N, d=c.D)
keys = ("ms_per_leapfrog", "ms_per_iteration", "host_syncs_per_leapfrog",
        "host_syncs_per_iteration", "num_leapfrog", "num_iterations",
        "chain_seconds")
prof = ("device_kernels_per_leapfrog", "device_busy_ms_per_leapfrog",
        "device_busy_share", "wall_ms_per_leapfrog_profiled")

def pick(out, profile, launches):
    row = {k: out[k] for k in keys if k in out}
    row.update({k: profile.get(k) for k in prof})
    row["launches"] = {k: v for k, v in launches.items() if v}
    return row

result = {}
if "NUTS" in phases:
    path, counts = c.run_main_path(dev, data, 0.0)
    result["NUTS"] = pick(path["adaptive"], path["profile"], counts)
    result["NUTS fixed step"] = {k: path["fixed_step"][k] for k in
                                 ("ms_per_leapfrog", "num_leapfrog")}
if "HMM" in phases:
    enum, enum_counts = c.run_enum_hmm(dev)
    hmm = c.run_hmm(dev)
    hmm, hmm_counts = hmm if isinstance(hmm, tuple) else (hmm, {})
    result["enumerated HMM"] = pick(enum, enum["profile"], enum_counts)
    result["semi-supervised HMM"] = pick(hmm, {}, hmm_counts)
if "ChEES" in phases:
    chees, chees_counts = c.run_chees(dev, data)
    result["ChEES"] = pick(chees, chees["profile"], chees_counts)
if "MRW" in phases:
    mala, mala_counts, mean = c.run_mrw(dev, data, "MALA")
    rwm, rwm_counts, _ = c.run_mrw(dev, data, "RWM",
                                   init_w=torch.from_numpy(mean))
    result["MALA"] = pick(mala, mala["profile"], mala_counts)
    result["RWM"] = pick(rwm, rwm["profile"], rwm_counts)
print("RESULT " + json.dumps(result))
"""
PHASES = ("NUTS", "HMM", "ChEES", "MRW")


def run(tree: Path, tag: str, phases) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, ",".join(phases)],
                          cwd=tree, env=env, capture_output=True, text=True,
                          timeout=1200)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{tag} run in {tree} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    return {"tree": tag, **json.loads(lines[-1][len("RESULT "):])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout to compare with (git archive)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="a comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases takes a subset of {','.join(PHASES)}")
    import torch
    if not torch.cuda.is_available():
        print("sampler_steps needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = [run(tree, tag, phases) for tree, tag in (
        (args.parent.resolve(), "parent"), (ROOT, "this tree"),
        (ROOT, "this tree"), (args.parent.resolve(), "parent"))]
    result = {"card": card, "runs": runs}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
