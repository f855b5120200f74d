"""Training launcher (the port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch gemma-2b --reduced --device cpu --steps 3

Runs real MAP training steps on one device (the card unless ``--device``
names another; ``RPL502`` without one): parameters drawn from seed 0 on the
device, ``LM(cfg, remat="full")``, the batches of ``SyntheticLMData`` by
step.  As in the JAX launcher, a straggler watchdog flags steps slower than
3x the running median.  Fault tolerance is the JAX launcher's:
``--ckpt-dir`` saves the train state (``{"params", "opt", "step"}``, through
:mod:`repro_torch.distributed.checkpoint`) every ``--checkpoint-every``
steps and at ``--steps``, a relaunch resumes from the checkpoint there
(the data cursor is the step, so it replays the exact batches), and
SIGTERM/SIGINT stop the run at the next step boundary, writing a
preemption checkpoint (``extra["preempted"]``) when there is a
``--ckpt-dir``.

``--mesh AxB`` trains on a ``(data=A, model=B)`` mesh over the process
group's ranks, one device each (``launch.mesh.make_host_mesh``; A x B must
be the rank count): the run sits in ``sharding_ctx`` with ``make_rules``'
rules, the train state is placed by ``param_shardings``, every batch by
``batch_sharding``, and a resume places the checkpoint's parameters on
this mesh whatever mesh wrote it.  Four gloo ranks on the CPU::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch gemma-2b \
        --reduced --device cpu --mesh 2x2 --steps 3

On cards each rank takes the card ``LOCAL_RANK`` names.  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import time

import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config
from ..core.infer.hmc import resolve_device
from ..data import SyntheticLMData
from ..distributed import checkpoint as ckpt
from ..distributed.sharding import (batch_sharding, make_rules,
                                    param_shardings, place)
from ..models import LM, reduced
from ..models.common import sharding_ctx
from ..optim import tree_map
from . import steps as steps_mod
from .mesh import make_host_mesh
from .serve import _sync


def _restore_into(state, directory, shardings=None):
    """The checkpoint in ``directory`` written into ``state``'s tensors
    (read through the host, so the device holds one copy of the state;
    on a mesh each leaf placed by ``shardings``, or as the state's own
    DTensor lies), its host numbers (the step, the optimizer's counts)
    taken as saved.  Returns ``(state, step)``."""
    saved, step, _ = ckpt.restore(state, directory, device="cpu",
                                  shardings=shardings)
    return tree_map(lambda dst, src: dst.copy_(src)
                    if isinstance(dst, torch.Tensor) else src,
                    state, saved), step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    mesh = rules = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split("x"))
        if device.type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        mesh = make_host_mesh(shape, devices=device.type)
        rules = make_rules(cfg, mesh)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    ctx = sharding_ctx(mesh, rules) if mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        return _run(args, cfg, device, mesh, rules)


def _run(args, cfg, device, mesh, rules):
    log = mesh is None or dist.get_rank() == 0
    data = SyntheticLMData(cfg.vocab_size, args.seq_len, args.global_batch)
    hp = steps_mod.TrainHParams(learning_rate=args.lr,
                                num_microbatches=args.microbatches,
                                total_steps=args.steps)
    lm = LM(cfg, remat="full")
    state = steps_mod.make_train_state(lm, hp, rng=0, device=device)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        shardings = None
        if mesh is not None:
            shapes, spec = lm.abstract_params()
            shardings = {"params": param_shardings(spec, rules, mesh,
                                                   shapes=shapes)}
        state, start = _restore_into(state, args.ckpt_dir, shardings)
        if log:
            print(f"[train] resumed from step {start}", flush=True)
    step_fn = steps_mod.make_train_step(
        lm, hp, total_tokens=args.global_batch * args.seq_len)
    on_mesh = (lambda b: b) if mesh is None else (
        lambda b, s=batch_sharding(rules, mesh): {
            k: place(v, mesh, s.placements) for k, v in b.items()})

    # preemption: SIGTERM/SIGINT checkpoint at the next step boundary and
    # return (a relaunch replays the exact batches from there)
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True   # no I/O here: not reentrant-safe
    previous = {s: signal.signal(s, _on_term)
                for s in (signal.SIGTERM, signal.SIGINT)}

    recent, history = [], []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            ts = time.time()
            batch = on_mesh(data.batch_at(i, device=device))
            state, metrics = step_fn(state, batch)
            _sync(device)
            dt_step = time.time() - ts
            # straggler watchdog: flag steps slower than 3x the median
            if len(recent) >= 5:
                med = sorted(recent)[len(recent) // 2]
                if dt_step > 3 * med:
                    print(f"[train][watchdog] step {i+1} took "
                          f"{dt_step:.2f}s (median {med:.2f}s) — straggler",
                          flush=True)
            recent = (recent + [dt_step])[-50:]
            if preempted["flag"]:
                if args.ckpt_dir:
                    ckpt.save(state, args.ckpt_dir, step=i + 1,
                              extra={"arch": args.arch, "preempted": True})
                    if log:
                        print(f"[train] preemption checkpoint at step "
                              f"{i+1}; exiting", flush=True)
                elif log:
                    print(f"[train] stopped by a signal after step {i+1}",
                          flush=True)
                return state, history
            if (i + 1) % args.log_every == 0 or i == start:
                ce = float(metrics["ce"])
                loss = float(metrics["loss"])
                history.append({"step": i + 1, "ce": ce, "loss": loss})
                dt = (time.time() - t0) / (i + 1 - start)
                toks = args.global_batch * args.seq_len / dt
                if log:
                    print(f"[train] step {i+1}/{args.steps} ce={ce:.4f} "
                          f"map_loss={loss:.1f} {dt*1e3:.0f} ms/step "
                          f"{toks:.0f} tok/s", flush=True)
            if args.ckpt_dir and (i + 1) % args.checkpoint_every == 0:
                ckpt.save(state, args.ckpt_dir, step=i + 1,
                          extra={"arch": args.arch})
                if log:
                    print(f"[train] checkpointed step {i+1}", flush=True)
        if args.ckpt_dir:
            ckpt.save(state, args.ckpt_dir, step=args.steps,
                      extra={"arch": args.arch})
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    return state, history


if __name__ == "__main__":
    main()
