"""Step builders for serving (the port of ``repro/launch/steps.py``'s
serving half): ``prefill_step`` returns the next-token logits of a prompt
batch; ``serve_step`` decodes one token against the KV cache and draws the
next token through a ``sample`` site — the paper's predictive pattern.

``TrainHParams`` and ``make_train_step`` wait for the training slice.
"""
from __future__ import annotations

import torch

from ..core import dist
from ..core.primitives import sample
from ..models import LM


def make_prefill_step(lm: LM):
    def prefill_step(w, batch):
        return lm.forward(w, batch, return_logits="last")
    return prefill_step


def make_serve_step(lm: LM, temperature: float = 1.0,
                    return_logits: bool = False):
    """``serve_step(w, cache, tokens (B, 1), pos, generator) -> (next (B, 1)
    int32, cache)``, plus the step's logits (B, V) when ``return_logits``.
    ``pos`` is a host int; the cache is written in place.  The draw's
    uniforms come from ``generator`` (a CPU generator: ``Categorical``
    draws them on the host)."""
    def serve_step(w, cache, tokens, pos, generator: torch.Generator):
        logits, cache = lm.decode_step(w, tokens, cache, pos)
        nxt = sample("next_token",
                     dist.Categorical(logits=logits / temperature),
                     generator=generator)
        nxt = nxt[:, None].to(torch.int32)
        return (nxt, cache, logits) if return_logits else (nxt, cache)
    return serve_step
