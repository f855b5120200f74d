"""NUTS tree lengths on the card through the fused leaf kernels and through
their plain versions, over seeds, with every kernel call checked.

    PYTHONPATH=src python -m repro_torch.bench.nuts_trees [--seeds 3]
        [--out FILE]

On the 581,012 x 54 logistic regression of ``chip_smoke.py``, runs
``MCMC(NUTS(logreg_model_glm), 100, 100)`` at seeds 0 .. S-1 twice:

- ``kernel``: through ``nuts_leaf``/``nuts_turning``, each call shadowed by
  its plain version on the same inputs (checkpoint rows cloned first): the
  vectors and checkpoint rows must be bit-identical, and the U-turn
  verdicts (any dot <= 0) and the leaf energies are compared;
- ``plain``: ``ops.nuts_leaf``/``ops.nuts_turning`` routed to the plain
  versions on the card (row 1's kernel still opens each subtree).

A NUTS chain is chaotic in its rounding: the two routes sum ke and the
dots in another order, so their trajectories part after a few leapfrogs,
and only the distribution over seeds of tree length, step size and accept
probability can be compared.  Prints one JSON object and writes it to
``--out`` (default ``src/repro_torch/build/bench/nuts_trees.json``).
Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.bench.models import (  # noqa: E402
    covtype_data, logreg_model_glm)
from repro_torch.core.infer import MCMC, NUTS  # noqa: E402
from repro_torch.kernels import leapfrog as lf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

OUT = ROOT / "src" / "repro_torch" / "build" / "bench" / "nuts_trees.json"


class Shadow:
    """The fused ops' kernels, each call held against the plain version."""

    def __init__(self):
        self.stats = {"leaf_calls": 0, "leaf_vectors_differ": 0,
                      "verdicts_differ": 0, "max_energy_rel_diff": 0.0,
                      "turning_calls": 0, "turning_verdicts_differ": 0}

    def leaf(self, r_half, z, grad, pe, m_inv, eps, r_sum, ck, sck,
             ckpt_i=None, idx_min=0, idx_max=-1):
        ck0, sck0 = ck.clone(), sck.clone()
        got = lf.nuts_leaf_cuda(r_half, z, grad, pe, m_inv, eps, r_sum, ck,
                                sck, ckpt_i, idx_min, idx_max)
        want = lf.nuts_leaf_ref(r_half, z, grad, pe, m_inv, eps, r_sum, ck0,
                                sck0, ckpt_i, idx_min, idx_max)
        s = self.stats
        s["leaf_calls"] += 1
        same = all(cs.same_bits(got[i], want[i]) for i in (0, 1, 3, 4)) \
            and cs.same_bits(ck, ck0) and cs.same_bits(sck, sck0)
        s["leaf_vectors_differ"] += not same
        g, w = got[2].tolist(), want[2].tolist()
        s["verdicts_differ"] += any(v <= 0 for v in g[2:]) != \
            any(v <= 0 for v in w[2:])
        energy = abs(w[0] + w[1])
        if energy > 0:
            s["max_energy_rel_diff"] = max(
                s["max_energy_rel_diff"], abs((g[0] + g[1]) - (w[0] + w[1]))
                / energy)
        return got

    def turning(self, m_inv, r_left, r_right, r_sum):
        got = lf.nuts_turning_cuda(m_inv, r_left, r_right, r_sum)
        want = lf.nuts_turning_ref(m_inv, r_left, r_right, r_sum)
        self.stats["turning_calls"] += 1
        self.stats["turning_verdicts_differ"] += \
            any(v <= 0 for v in got.tolist()) != \
            any(v <= 0 for v in want.tolist())
        return got


def run(data, seed, route):
    leaf, turning = ops.FUSED["nuts_leaf"], ops.FUSED["nuts_turning"]
    shadow = Shadow()
    ops.reset_launch_counts()
    if route == "kernel":
        ops.FUSED["nuts_leaf"] = leaf._replace(kernel=shadow.leaf)
        ops.FUSED["nuts_turning"] = turning._replace(kernel=shadow.turning)
    else:
        ops.FUSED["nuts_leaf"] = leaf._replace(kernel=leaf.ref)
        ops.FUSED["nuts_turning"] = turning._replace(kernel=turning.ref)
    try:
        mcmc = MCMC(NUTS(logreg_model_glm), num_warmup=100, num_samples=100)
        mcmc.run(seed, data["x"], y=data["y"])
    finally:
        ops.FUSED["nuts_leaf"], ops.FUSED["nuts_turning"] = leaf, turning
    counts = ops.launch_counts()
    extra = mcmc.get_extra_fields()
    w = mcmc.get_samples()["w"].detach().cpu().numpy()
    row = {"route": route, "seed": seed,
           "num_leapfrog": mcmc.stats["num_leapfrog"],
           "mean_num_steps": float(extra["num_steps"].float().mean()),
           "mean_accept_prob": float(extra["accept_prob"].float().mean()),
           "step_size": float(extra["step_size"][-1]),
           "divergences": int(extra["diverging"].sum()),
           "max_abs_posterior_mean_minus_true_w": float(
               np.max(np.abs(w.mean(0) - data["true_w"]))),
           "nuts_leaf_launches": counts["nuts_leaf"]}
    if route == "kernel":
        row.update(shadow.stats)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nuts_trees needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    data = covtype_data(seed=0, n=cs.N, d=cs.D)
    runs = [run(data, seed, route) for seed in range(args.seeds)
            for route in ("kernel", "plain")]
    result = {"card": card, "runs": runs}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
