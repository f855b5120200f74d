"""Training launcher (the port of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch gemma-2b --reduced --device cpu --steps 3

Runs real MAP training steps on one device (the card unless ``--device``
names another; ``RPL502`` without one): parameters drawn from seed 0 on the
device, ``LM(cfg, remat="full")``, the batches of ``SyntheticLMData`` by
step.  As in the JAX launcher, a straggler watchdog flags steps slower than
3x the running median, and SIGTERM/SIGINT stop the run at the next step
boundary.  Checkpointing (``--ckpt-dir``) and the device mesh (``--mesh``)
raise ``RPL501``: they wait for their items of the port (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import signal
import time

from ..configs import ARCHS, get_config
from ..core.errors import pending
from ..core.infer.hmc import resolve_device
from ..data import SyntheticLMData
from ..models import LM, reduced
from . import steps as steps_mod
from .serve import _sync


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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        raise pending("checkpointing (--ckpt-dir)", "checkpoint")
    if args.mesh:
        raise pending("the device mesh (--mesh)", "multi-GPU")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    data = SyntheticLMData(cfg.vocab_size, args.seq_len, args.global_batch)
    hp = steps_mod.TrainHParams(learning_rate=args.lr,
                                num_microbatches=args.microbatches,
                                total_steps=args.steps)
    lm = LM(cfg, remat="full")
    state = steps_mod.make_train_state(lm, hp, rng=0, device=device)
    step_fn = steps_mod.make_train_step(
        lm, hp, total_tokens=args.global_batch * args.seq_len)

    # preemption: SIGTERM/SIGINT stop at the next step boundary
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True   # no I/O here: not reentrant-safe
    previous = {s: signal.signal(s, _on_term)
                for s in (signal.SIGTERM, signal.SIGINT)}

    recent, history = [], []
    t0 = time.time()
    try:
        for i in range(args.steps):
            ts = time.time()
            batch = data.batch_at(i, device=device)
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
                print(f"[train] stopped by a signal after step {i+1}",
                      flush=True)
                break
            if (i + 1) % args.log_every == 0 or i == 0:
                ce = float(metrics["ce"])
                loss = float(metrics["loss"])
                history.append({"step": i + 1, "ce": ce, "loss": loss})
                dt = (time.time() - t0) / (i + 1)
                toks = args.global_batch * args.seq_len / dt
                print(f"[train] step {i+1}/{args.steps} ce={ce:.4f} "
                      f"map_loss={loss:.1f} {dt*1e3:.0f} ms/step "
                      f"{toks:.0f} tok/s", flush=True)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    return state, history


if __name__ == "__main__":
    main()
