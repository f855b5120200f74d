"""Train the LM on a device mesh across ranks and hold it against the
unsharded run.

    torchrun --nproc-per-node 4 -m repro_torch.bench.lm_mesh --mesh 2x2
        [--arch gemma-2b] [--layers 2] [--batch 4] [--seq 1024]
        [--steps 3] [--device cpu] [--out FILE]

Every rank builds the ``(data, model)`` mesh over the process group
(``launch.mesh.make_host_mesh``), the float32 model at the configuration's
full width cut to ``--layers`` layers (``--reduced`` for the smoke size),
the train state placed by ``param_shardings`` under ``sharding_ctx``, and
runs ``--steps`` AdamW steps of ``make_train_step`` on ``SyntheticLMData``
batches placed by ``batch_sharding``, each step ended by a synchronize and
timed on the host clock; the launch counters are read per rank.  Rank 0
then runs the same steps unsharded on its own device, and the script
prints, from rank 0, one JSON object: the card (``nvidia-smi`` name and
power limit) or the CPU, the mesh, each step's ms and loss on the mesh and
unsharded, the largest loss and parameter differences, and each rank's
launches a step against the unsharded step's.  On cards each rank takes
the card ``LOCAL_RANK`` names.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..data import SyntheticLMData
from ..distributed import sharding
from ..kernels import ops
from ..models import LM, reduced
from ..models.common import sharding_ctx
from ..optim import tree_leaves


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]


def _steps(lm, hp, data, steps, device, place=None):
    """``steps`` train steps from seed 0: (state, [ms], [loss], launches a
    step)."""
    from ..launch import steps as steps_mod
    state = steps_mod.make_train_state(
        lm, hp, rng=torch.Generator(device=device).manual_seed(0),
        device=device)
    step = steps_mod.make_train_step(lm, hp, data.seq_len * data.global_batch)
    ms, losses = [], []
    ops.reset_launch_counts()
    for i in range(steps):
        batch = data.batch_at(i, device=device)
        if place is not None:
            batch = place(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics["loss"]))
    launches = {k: v / steps for k, v in ops.launch_counts().items() if v}
    return state, ms, losses, launches


def main(argv=None):
    from ..core.infer.hmc import resolve_device
    from ..launch import steps as steps_mod
    from ..launch.mesh import make_host_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cfg = reduced(cfg, num_layers=args.layers) if args.reduced else \
        dataclasses.replace(cfg, num_layers=args.layers, dtype="float32")
    lm = LM(cfg, remat="full")
    hp = steps_mod.TrainHParams(learning_rate=3e-4, warmup_steps=1)
    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch, seed=0)
    mesh = make_host_mesh(tuple(int(n) for n in args.mesh.split("x")),
                          devices=device.type)
    rules = sharding.make_rules(cfg, mesh)
    placements = sharding.batch_sharding(rules, mesh).placements

    def place(batch):
        return {k: sharding.place(v, mesh, placements)
                for k, v in batch.items()}

    with sharding_ctx(mesh, rules):
        meshed, ms, losses, launches = _steps(lm, hp, data, args.steps,
                                              device, place)
    params = [p.full_tensor() for p in tree_leaves(meshed["params"])]
    del meshed
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, launches)
    if dist.get_rank() != 0:
        sharding.barrier(mesh)
        return None
    plain, plain_ms, plain_losses, plain_launches = _steps(
        lm, hp, data, args.steps, device)
    out = {"card": _card(device), "ranks": dist.get_world_size(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "batch": args.batch, "seq": args.seq, "steps": args.steps,
           "mesh_ms": ms, "plain_ms": plain_ms,
           "mesh_loss": losses, "plain_loss": plain_losses,
           "max_loss_diff": max(abs(a - b) for a, b in
                                zip(losses, plain_losses)),
           "max_param_diff": max(
               float((a.to(b.device) - b).abs().max()) for a, b in
               zip(params, tree_leaves(plain["params"]))),
           "launches_per_step_by_rank": every,
           "plain_launches_per_step": plain_launches}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    sharding.barrier(mesh)
    return out


if __name__ == "__main__":
    main()
    dist.destroy_process_group()
