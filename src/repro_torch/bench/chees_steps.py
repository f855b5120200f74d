"""ChEES on the card through its fused kernels and through their plain
versions, with every ``chees_accept`` call checked.

    PYTHONPATH=src python -m repro_torch.bench.chees_steps [--draws 300]
        [--out FILE]

On the 581,012 x 54 logistic regression of ``chip_smoke.py``, runs
``MCMC(ChEES(logreg_model_glm), 300, DRAWS, num_chains=8)`` at seed 0
twice:

- ``kernel``: the trajectory replayed from its CUDA graphs through
  ``chees_open`` and the batch leapfrog, each ``chees_accept`` call
  shadowed by its plain version on the same inputs: the accept decisions
  and divergences compared, accept_prob's and the gradient's largest
  relative difference, and, where the decisions agree, the selections,
  the running mean and the Welford fold bit for bit;
- ``plain``: ``ops.chees_open``, ``ops.leapfrog_halfstep_batch`` and
  ``ops.chees_accept`` routed to their plain versions on the card (the
  graphs then capture the plain ops).

The two routes sum ke and the centred sums in another order, so a
``ceil`` of the trajectory length can flip by rounding; the report says
whether the ``num_steps`` sequences of the 300 + DRAWS iterations are the
same, or at which iteration they first differ.  Prints one JSON object
and writes it to ``--out`` (default
``src/repro_torch/build/bench/chees_steps.json``).  Needs a card and
``nvcc``.
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
from repro_torch.core.infer import MCMC, ChEES  # noqa: E402
from repro_torch.kernels import leapfrog as lf  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

OUT = ROOT / "src" / "repro_torch" / "build" / "bench" / "chees_steps.json"


class Shadow:
    """``chees_accept``'s kernel, each call held against the plain
    version on the same inputs."""

    def __init__(self):
        self.stats = {"calls": 0, "decisions_differ": 0,
                      "divergences_differ": 0, "outputs_differ": 0,
                      "max_accept_prob_rel_diff": 0.0,
                      "max_gradient_rel_diff": 0.0,
                      "max_hmean_rel_diff": 0.0}

    def __call__(self, *args):
        got = lf.chees_accept_cuda(*args)
        want = lf.chees_accept_ref(*args)
        s = self.stats
        s["calls"] += 1
        u = args[10]
        same_choice = torch.equal(u < got[4], u < want[4])
        s["decisions_differ"] += not same_choice
        s["divergences_differ"] += not torch.equal(got[5], want[5])
        ap, ap_p = got[4].double(), want[4].double()
        finite = ~(ap.isnan() | ap_p.isnan())
        if bool(finite.any()):
            rel = ((ap - ap_p).abs() / ap_p.abs().clamp(min=1e-30))[finite]
            s["max_accept_prob_rel_diff"] = max(
                s["max_accept_prob_rel_diff"], float(rel.max()))
        if same_choice:
            pairs = list(zip(got[:3], want[:3]))
            if got[7] is None:
                pairs.append((got[6], args[12] + (got[4] - args[12])
                              / args[13]))
            if got[8] is not None:
                pairs += list(zip(got[8], want[8]))
            s["outputs_differ"] += not all(cs.same_bits(a, b)
                                           for a, b in pairs)
        if got[7] is not None:
            k, p = got[7].double().tolist(), want[7].double().tolist()
            for i, key in ((0, "max_hmean_rel_diff"),
                           (1, "max_gradient_rel_diff")):
                s[key] = max(s[key], abs(k[i] - p[i]) / max(abs(p[i]),
                                                            1e-30))
        return got


def run(data, route, draws):
    names = (("chees_open", ops.FUSED), ("chees_accept", ops.FUSED),
             ("leapfrog_halfstep_batch", ops.SPECS))
    saved = {name: table[name] for name, table in names}
    shadow = Shadow()
    ops.reset_launch_counts()
    if route == "kernel":
        ops.FUSED["chees_accept"] = saved["chees_accept"]._replace(
            kernel=shadow)
    else:
        for name, table in names:
            table[name] = saved[name]._replace(kernel=saved[name].ref)
    kernel, steps = ChEES(logreg_model_glm), []
    setup = kernel.setup

    def recording_setup(*args, **kwargs):
        """The setup, its transitions recording their ``num_steps``."""
        inner = setup(*args, **kwargs)

        def sample_fn(state, draws):
            state = inner.sample_fn(state, draws)
            steps.append(state.num_steps)
            return state

        sample_fn.trajectory_stats = inner.sample_fn.trajectory_stats
        return inner._replace(sample_fn=sample_fn)

    kernel.setup = recording_setup
    try:
        mcmc = MCMC(kernel, num_warmup=300, num_samples=draws, num_chains=8)
        mcmc.run(0, data["x"], y=data["y"])
    finally:
        for name, table in names:
            table[name] = saved[name]
    counts = ops.launch_counts()
    extra = mcmc.get_extra_fields(group_by_chain=True)
    w = mcmc.get_samples(group_by_chain=True)["w"].detach().cpu().numpy()
    row = {"route": route, "num_leapfrog": mcmc.stats["num_leapfrog"],
           "trajectory_graph": mcmc.stats["trajectory_graph"],
           "graph_replays": mcmc.stats["graph_replays"],
           "mean_accept_prob": float(extra["accept_prob"].float().mean()),
           "step_size": float(extra["step_size"][0, -1]),
           "divergences": int(extra["diverging"].sum()),
           "max_abs_posterior_mean_minus_true_w": float(
               np.max(np.abs(w.mean((0, 1)) - data["true_w"]))),
           "launches": {k: v for k, v in counts.items() if v}}
    if route == "kernel":
        row.update(shadow.stats)
    return row, steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=300)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chees_steps needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    data = covtype_data(seed=0, n=cs.N, d=cs.D)
    (kernel, steps_k), (plain, steps_p) = (run(data, route, args.draws)
                                           for route in ("kernel", "plain"))
    first = next((i for i, (a, b) in enumerate(zip(steps_k, steps_p))
                  if a != b), None)
    result = {"card": card, "runs": [kernel, plain],
              "iterations": len(steps_k),
              "num_steps_same": steps_k == steps_p,
              "num_steps_first_differs_at_iteration": first}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
