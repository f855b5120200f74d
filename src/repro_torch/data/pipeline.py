"""Deterministic, shard-aware synthetic token pipeline (the port of
``repro/data/pipeline.py``'s ``SyntheticLMData``).

Determinism by step is the fault-tolerance contract: ``batch_at(step)`` is a
pure function of (seed, step, shard), so a restarted worker replays exactly
its shard of the global batch.  Tokens are uniform in ``[3, vocab)``, with
EOS document boundaries at rate ``1 / mean_doc_len``; labels are the tokens
shifted by one, EOS last.

The bits differ from the JAX package's (a ``torch.Generator`` seeded from
``(seed, step, rank)`` instead of threefry): a test that compares the two
packages carries the JAX batch across as numpy.  The encoder-decoder
``SyntheticSeq2SeqData`` waits for its model family (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 2

    def batch_at(self, step: int, dp_rank: int = 0, dp_size: int = 1,
                 device="cpu"):
        """Local slice of the global batch for this step: ``{"tokens",
        "labels"}``, each (global_batch / dp_size, seq_len) int32 on
        ``device``."""
        if self.global_batch % dp_size:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {dp_size} data-parallel ranks")
        local = self.global_batch // dp_size
        # a CPU generator seeded from a hash of (seed, step, rank), so
        # neighbouring steps and ranks draw unrelated bits
        state = np.random.SeedSequence([self.seed, step, dp_rank])
        gen = torch.Generator().manual_seed(
            int(state.generate_state(1, np.uint64)[0]))
        tokens = torch.randint(3, self.vocab_size, (local, self.seq_len),
                               generator=gen, dtype=torch.int32)
        # EOS document boundaries with ~geometric spacing
        boundary = torch.rand((local, self.seq_len), generator=gen) \
            < 1.0 / self.mean_doc_len
        tokens = torch.where(boundary, self.eos_id, tokens)
        labels = torch.cat([tokens[:, 1:],
                            torch.full((local, 1), self.eos_id,
                                       dtype=torch.int32)], dim=1)
        return {"tokens": tokens.to(device), "labels": labels.to(device)}
