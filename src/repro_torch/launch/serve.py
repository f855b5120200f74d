"""Serving launcher (the port of ``repro/launch/serve.py``): batched decode
with the paper's predictive pattern, the next token drawn through a
``sample`` site.

    python -m repro_torch.launch.serve --arch qwen3-8b --reduced --device cpu
    python -m repro_torch.launch.serve --arch mamba2-370m --reduced --device cpu

Parameters are drawn from seed 0 on the serving device, prompts from numpy
seed 1 in ``[3, vocab)``, and the draw at position ``t`` from a CPU
generator seeded ``100 + t``, so a run is deterministic on one device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core.infer.hmc import resolve_device
from ..models import LM, reduced
from . import steps as steps_mod


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(lm: LM, w, prompt, new_tokens, temperature=1.0, seed=100):
    """Teacher-force ``prompt`` (B, P) through decode steps into a fresh
    cache of ``P + new_tokens`` positions, as the JAX launcher does (one
    step function for prompt and generation), then sample ``new_tokens``.

    Returns ``{"tokens": (B, P + new_tokens) int32, "first_logits": the
    (B, V) logits at position P - 1 (what a prefill of the prompt returns),
    "teacher_forced_seconds", "sampled_seconds"}``, each phase ended by a
    device synchronize."""
    B, P = prompt.shape
    device = prompt.device
    max_len = P + new_tokens
    cache = lm.init_cache(B, max_len, device=device)
    serve_step = steps_mod.make_serve_step(lm, temperature,
                                           return_logits=True)
    _sync(device)
    t0 = time.perf_counter()
    for t in range(P - 1):
        _, cache, _ = serve_step(w, cache, prompt[:, t:t + 1], t,
                                 torch.Generator().manual_seed(seed + t))
    _sync(device)
    t1 = time.perf_counter()
    tok, out, first_logits = prompt[:, P - 1:P], [prompt], None
    for t in range(P - 1, max_len - 1):
        tok, cache, logits = serve_step(
            w, cache, tok, t, torch.Generator().manual_seed(seed + t))
        if first_logits is None:
            first_logits = logits
        out.append(tok)
    seq = torch.cat(out, dim=1)
    _sync(device)
    return {"tokens": seq, "first_logits": first_logits,
            "teacher_forced_seconds": t1 - t0,
            "sampled_seconds": time.perf_counter() - t1}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    lm = LM(cfg)
    w = lm.init(torch.Generator(device=device).manual_seed(0))
    B, P = args.batch, args.prompt_len
    prompt = np.random.default_rng(1).integers(3, cfg.vocab_size, (B, P))
    prompt = torch.from_numpy(prompt.astype(np.int32)).to(device)
    t0 = time.perf_counter()
    result = generate(lm, w, prompt, args.tokens, args.temperature)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.arch}: generated {B}x{args.tokens} tokens in "
          f"{dt:.2f}s ({B * args.tokens / dt:.1f} tok/s incl. the prompt's "
          "teacher-forced steps)")
    print(result["tokens"][:, :P + 8])
    return result


if __name__ == "__main__":
    main()
