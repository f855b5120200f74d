"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line if any fails):

1. Print the card (``nvidia-smi --query-gpu=name,power.limit``) and build
   the hand-written kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together); print the bf16 tensor-core kernels'
   registers, shared memory, stack and spill (``cuobjdump -res-usage``) and
   their count of ``HGMMA``/``HMMA`` instructions (``cuobjdump -sass``),
   each of which must have at least one; then the device time of each
   kernel inside one bf16 dq pass (its delta kernel) and one rmsnorm
   backward (its two kernels) at gemma-2b's shapes.
   Then ``lint``: the registry invariants (``repro_torch.lint``'s
   ``verify_registry``: RPL201/202 over ``OP_TABLE``, ``FUSED`` and
   ``BACKWARD``, and RPL203, each of the 26 kernels launched against its
   plain version at its factory's shapes, within its row's bound); the
   model linter clean on the logreg at 581,012 x 54, the semi-supervised
   HMM at T = 600 and SKIM at p = 256 on the card, and once on meta
   tensors of the same shapes; ``analyze`` of each of those potentials
   with its gradient on the card, its findings printed (no gate); and
   ``MCMC(NUTS(logreg_model_glm), 10, 10, validate=True)`` against
   ``validate=False``: the draws bit-identical, the model linted once over
   two runs.  Its seconds are printed (``lint phase seconds``).
2. ``samplers``: hold each kernel of slices 1-3 against its plain PyTorch
   version on the card, at the main paths' shapes and at ragged ones, and
   time kernel and plain version with CUDA events (``enum_contract`` also
   against ``torch.logsumexp``, the library yardstick, and at a large
   shape; the chain kernels ``enum_chain``/``enum_chain_bwd`` also against
   T-1 one-step launches, bit for bit, and at 4,096 rows x K = 64; the
   batch leapfrog and the MALA/RWM proposal also at (64, 1,000,003); the
   GLM kernel at C = 1, 8 and 16 chains a call, each chain bit-identical
   to a 1-chain call, timed at each C beside its bound; the NUTS leaf ops
   ``nuts_leaf``/``nuts_turning`` at the NUTS paths' D (SKIM's 260 too),
   ragged D and 1,000,003, every leaf kind, vectors bit-identical and sums within 1e-6
   of their terms; ``mala_accept`` at the ensembles' shapes, MALA and RWM,
   in warmup and after, with divergent chains, the selections, running
   mean and harmonic mean bit-identical for the kernel's accept_prob; the
   batch leapfrog with its step size read from device memory bit-identical
   to the by-value form, ``chees_open`` bit-identical, and ``chees_accept``
   after warmup and in warmup, with the gradient, the Welford fold and an
   all-divergent ensemble, its sums within 1e-6 of their terms and the
   rest bit-identical for the kernel's accept_prob; then ChEES's graphed
   trajectory bit-identical to the eager one for 1 and 5 steps; the
   chain-batched NUTS leaf ops of lockstep NUTS, ``nuts_leaf_batch``,
   ``nuts_turning_batch`` and ``halfstep_chains``, at C = 1, 4, 8, 16 and
   D = 54, 10, 260, 4097, every leaf kind, active and inactive chains,
   both directions, vectors bit-identical and each active row's vectors
   bit-identical to a one-chain ``nuts_leaf`` launch; the backward sample
   of forward-filter/backward-sample, ``enum_chain_sample``, at T = 1, 2,
   120, 600 x K = 2, 3, 8, 33, 64 x 1 and 16 rows x float32/float64 and
   with planted ties, the draws bit-identical to its plain version, timed
   at T = 120 and 600 with ns a step).
   Then drive the main paths through the user's entry points,
   each with every kernel launch counter set to 0 just before and read just
   after: ``MCMC(NUTS(logreg_model_glm), 100, 100).run(...)`` on 581,012 x
   54 CoverType-shaped data made from a seed, then the paper's fixed-step
   configuration (0 warmup, 40 draws, step 0.0015, no adaptation), then the
   same logreg with 8 chains in lockstep (``chain_method="vectorized"``,
   100 + 100: one ``nuts_leaf_batch`` launch a lockstep leapfrog, one GLM
   launch a lockstep gradient, no one-chain ``nuts_leaf``; 0 divergences,
   the pooled mean within 0.05 of ``true_w``, split R-hat < 1.05; each
   chain's departure from a lone run of its seed and a profile in a fresh
   process printed); the
   fully-latent HMM ``MCMC(NUTS(enum_hmm_model, max_tree_depth=8), 50,
   50)`` at K = 8, T = 120, V = 16, whose states ``markov`` sums out
   through the chain kernels (one launch of each per gradient), then
   ``infer_discrete`` through the user's entry point: 1000 calls at the
   HMM's data-generating theta/phi (each one ``enum_chain`` and one
   ``enum_chain_sample`` launch, no ``enum_contract``; the states'
   marginals within 0.07 of float64 forward-backward), one call for each
   of the NUTS run's 50 draws (states in the support) and 1000 calls on
   examples/gmm.py's mixture at pinned weights/mu/sigma (within 0.07 of
   the exact softmax posterior); and the paper's semi-supervised
   ``hmm_model`` at T = 600, T_sup = 100, K = 3, V = 10 (50 warmup + 20
   draws); SKIM, the third paper model,
   ``MCMC(NUTS(skim_model, max_tree_depth=8), 100, 50)`` at p = 256, n =
   200 through the generic autograd potential (the library's Cholesky
   factor and triangular solve), gated on finite draws, at most 1 %
   divergent and the 6 planted dimensions the 6 largest posterior-median
   ``lambda``; the README's eight schools, non-centered by ``reparam`` with
   ``LocScaleReparam(0.0)``, NUTS 4 chains in lockstep 150 + 100, gated on
   split R-hat < 1.05, then ``Predictive`` of ``obs`` on the card, (400,
   8) and finite; ``NUTS(cross_chain_adapt=True)``, 4 chains 300 + 400 on
   tests/test_ensemble.py:186's conjugate normal (its bounds, one shared
   mass matrix); ``NUTS(dense_mass=True)`` 300 + 300 on
   tests/test_mcmc.py:191's correlated Gaussian (finite, ``|mean| < 0.2``,
   no leaf kernel); each one-chain NUTS run gated on exactly one
   ``nuts_leaf`` launch a leapfrog of its trees and ``leapfrog_halfstep``
   opening every subtree, each lockstep run on one ``nuts_leaf_batch`` a
   lockstep leapfrog and ``halfstep_chains`` opening every lockstep
   subtree; then the ensemble samplers on the same logreg
   data: ``MCMC(ChEES(logreg_model_glm), 300, 1500, num_chains=8)``
   (lockstep trajectories replayed from two CUDA graphs, ``chees_open``
   and ``chees_accept`` once an iteration, ``leapfrog_halfstep_batch``
   once an interior step, and over 20 profiled transitions, in a fresh
   process, the profiler's count of each kernel equal to its launch
   counter's increase),
   ``MCMC(MALA(logreg_model_glm), 500, 500, num_chains=16)`` and ``RWM``
   at the same setting warm-started at MALA's posterior mean (one
   ``mala_step`` and one ``mala_accept`` launch per iteration, RWM's
   without the gradient); each
   evaluates all its chains' gradients in one GLM launch, the prior under
   ``torch.func.vmap`` (gated: ``glm_prior_batch == "vmap"``, one launch
   per ensemble evaluation and per search evaluation plus the setup's
   check, chain evaluations one per chain and evaluation plus that check).
3. ``checkpoint``: kill and resume on the card through the user's entry
   points (``MCMC.run(..., checkpoint_every, checkpoint_dir, resume)`` and
   ``launch.train.main --ckpt-dir``), the checkpoints under a temporary
   directory removed at the end; a kill is a private ``BaseException``
   raised from a wrapper around ``checkpoint.save`` right after a save
   (``recorded_saves``): one tree of CUDA float32/float64/bf16/int64/bool
   tensors and host leaves through ``save`` and ``restore``, the same
   bits, dtypes, devices and types back; ``MCMC(NUTS(logreg_model_glm),
   24, 36, num_chains=4)`` on the 581,012 x 54 data, ``checkpoint_every``
   20 (exactly 6 saves; the state write's ms and bytes, the run's seconds
   with and without checkpoints), and killed after save 3 (which leaves the
   orphaned ``samples_000024_000044``) and resumed, every collected field,
   the final state and the generators' final states bit-identical to the
   uninterrupted card run, ``nuts_leaf_batch`` and the GLM kernel launched
   in the resumed part; ``ChEES`` 60 + 80 with 8
   chains killed mid-warmup (after save 2 of chunks of 25) and resumed from
   its CUDA graphs; ``MALA`` 24 + 36 with 16 chains killed after save 3;
   the launcher on the reduced gemma-2b, 4 steps checkpointed every 2 and
   relaunched to 6 (``resumed from step 4``), its parameters and optimizer
   state bit-identical to an uninterrupted 6-step run.
   Then ``mesh``, on a one-rank process group (NCCL; gloo with CUDA
   tensors, printed, where NCCL cannot start): ``glm_potential_partials``
   (row 2's kernel over a shard grid dimension) at 581,012 x 54 with S =
   1, 2, 4 and at (28,028, 7) with S = 1, 2, 4, 7, both families there, C
   = 1, 8, 16: one launch and C * S shard evaluations a call, each partial
   within row 2's bound of the float64 plain loop and bit-identical to a
   one-shard launch on its rows (the odd shards of the main shape start
   unaligned: 4-byte copies), timed at S = 1, 2, 4 x C = 1, 8 beside S
   one-shard launches, the unsharded launch and one aligned and one odd
   shard; then ``MCMC(NUTS(logreg_model_glm, data_shards=4), 24, 36,
   num_chains=4)`` under ``"vectorized"`` and under ``"parallel"`` on the
   (1, 1) mesh checkpointed every 17 (chunks that do not divide the
   phases), byte-identical, each with one ``glm_potential_partials``
   launch a gradient and no one-shard GLM launch, 0 divergences and the
   pooled mean within 0.05 of ``true_w``; the parallel checkpoint, copied
   after its first samples write, resumed under ``"vectorized"``,
   byte-identical; ms a lockstep leapfrog beside the checkpoint phase's
   uninterrupted run, the same run without shards.  The parallel run has
   telemetry on (the metric series of its 4 chains, in memory), and a
   one-rank mesh dim runs no collective.
   Then ``obs``: the checkpoint phase's three configurations run once more
   with ``telemetry=obs.Telemetry(...)``, each held against that phase's
   uninterrupted run without it (every collected field and the final
   state bit-identical, every launch count equal, host syncs at most one
   more a chunk, and one more a chunk that diverged):
   ``MCMC(NUTS(logreg_model_glm), 24, 36, num_chains=4)`` in chunks of 20
   (ms a lockstep leapfrog with and without; ``events.jsonl`` and
   ``run_manifest.json`` valid, the manifest's card the one ``nvidia-smi``
   names and its power limit read), then gated (``until=Converged(
   max_rhat=1.05, check_every=20, batch_size=5, max_samples=200)``), its
   draws the ungated run's prefix bit for bit, its decision printed;
   ``ChEES`` (8 chains, 60 + 80): the trajectory graphed with the same
   replays, only the first chunk span ``program_cold`` (the graphs'
   capture); ``MALA`` (16 chains, 24 + 36).
   Then ``svi``: ``SVI(model, AutoNormal(model), optim.adam(5e-2),
   Trace_ELBO()).run(0, steps, x, y)`` of benchmarks/svi_minibatch.py's
   logistic regression on the same 581,012 x 54 data on the card, full
   batch (400 steps) and with minibatches of n / 100 (1000 steps, the
   benchmark's count), gated on the loss falling (median of the last 50
   below the first 50), ``max|median(m) - true_w| < 0.1`` and the two
   fits' medians within 0.1; ms, host syncs and peak memory a step, and a
   profile of both (device busy share, kernels a step) in a fresh process.
4. ``lm``: hold ``rmsnorm`` and ``flash_attention`` against their plain
   versions (float32 and bfloat16, causal and not, MHA/GQA/MQA, dq != dv,
   ragged) and time them beside ``F.rms_norm`` and
   ``F.scaled_dot_product_attention`` (the attention also at gemma-2b's
   training shape, the forward of its 72 launches a step; ``rmsnorm`` and
   ``F.rms_norm`` at (2048, 4096) also cold, the input rotated over copies
   that overflow L2); then the full
   Qwen3-8B (bf16,
   params drawn on the card from seed 0): ``make_prefill_step`` at B = 4,
   P = 512 (145 ``rmsnorm`` and 36 ``attention`` launches), and the
   launcher's serving loop (``serve.generate``: the prompt teacher-forced,
   then 32 sampled tokens; 145 ``rmsnorm`` launches and no ``attention``
   per step), its logits at P - 1 against the prefill's; per-token time
   split, device busy share, memory peak; then a full-width 2-layer
   float32 Qwen3 through the kernels against the plain versions: its
   prefill, and 8 decode steps teacher-forced into a fresh cache.
5. ``train``: hold the ``rmsnorm`` backward, the flash-attention dq and
   dkv passes and ``softmax_xent`` against their plain versions (float32
   and bfloat16, causal and not, MHA/GQA/MQA, head dims 128 and 256, dq !=
   dv, a ragged S, T and V, the xent weight as (d, V) and as a tied (V, d)
   embedding's transpose; the bf16 ``softmax_xent`` backward, its dlogits
   kernel and products, within one bf16 step of the plain float32
   backward) and time them beside SDPA's backward; then the
   full gemma-2b (bf16, params drawn on the card from seed 0, remat
   "full"): ``make_train_state`` and ``make_train_step`` (the MAP loss with
   the handler-scored log-prior, 2 microbatches, AdamW) for 8 steps on one
   fixed batch of B = 4 x 1024 tokens, the loss falling and 146 ``rmsnorm``,
   74 ``rmsnorm_bwd``, 72 ``attention``, 36 ``attention_dq``, 36
   ``attention_dkv``, 2 ``softmax_xent`` and 2 ``softmax_xent_bwd``
   launches per step; a profiled
   step; ``launch.train.main`` for 2 steps; then a full-width 2-layer
   float32 gemma's loss and every gradient through the kernels against the
   plain versions, and the same model on a one-rank (1, 1) LM mesh
   (``sharding_ctx``, DTensor parameters, the kernels through
   ``local_map``): its loss and gradients, then one ``make_train_step``
   step's metrics and parameters, bit-identical to the unsharded kernel
   step's, with the same launches.
6. ``ssm``: hold ``ssd_scan`` against its plain version (float32 within
   1e-4; bfloat16 ``y`` within one rounding step and the float32 state
   within 1e-4 of its largest entry; with and without ``D``, with ``h0``,
   one and two B/C groups, chunks of 256, 64 and one shorter than 256; a
   ragged length raises), and ``SsdScan``'s kernel forward and its
   gradients against autograd of the plain version; time it at
   mamba2-370m's prefill shape, with its achieved TFLOP/s on the
   operations the scan needs (``ssd_work``); then the
   full mamba2-370m (bf16, params drawn on the card from seed 0):
   ``make_prefill_step`` at B = 4, P = 2048 (48 ``ssd_scan`` and 49
   ``rmsnorm`` launches), the launcher's serving loop at B = 4, P = 512
   plus 32 sampled tokens (no ``ssd_scan`` and 49 ``rmsnorm`` launches per
   step: decode is the O(1) state update), its logits at P - 1 against a
   prefill's, per-token split, busy share, memory peak; then a full-width
   2-layer float32 mamba2 through the kernels against the plain versions:
   its prefill, 8 decode steps teacher-forced into a fresh cache, and the
   caches.
7. Print the phases' seconds, the wall seconds and the card, one
   ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
         torch.bfloat16: 989e12}
N, D = 581_012, 54
GLM_REL_TOL = 1e-5
# the GLM kernel's chains a call: the NUTS path's, ChEES's, MALA/RWM's
GLM_CHAINS = (1, 8, 16)
ENUM_K, ENUM_T, ENUM_V = 8, 120, 16
# its draws are cut from 100 + 100 (never K or T) to make room for the
# ensemble phases within the script's time
ENUM_WARMUP, ENUM_DRAWS = 50, 50
HMM_T, HMM_T_SUP, HMM_K, HMM_V = 600, 100, 3, 10
# its draws are cut (never T) to keep the script near 6 minutes: at
# ~150 ms per leapfrog 50 + 50 took 272 s on an H100
HMM_WARMUP, HMM_DRAWS = 50, 20
# enum_contract checks: the main path's shape, the ragged shapes of
# tests/test_kernels.py:268-270, Ki = 1, and the large timing shape
ENUM_MAIN, ENUM_LARGE = ((), ENUM_K, ENUM_K), ((16384,), 64, 64)
ENUM_SHAPES = (ENUM_MAIN, ((), 2, 2), ((), 3, 3), ((), 16, 16),
               ((), 128, 128), ((), 7, 13), ((), 257, 5), ((4,), 8, 8),
               ((2, 3), 5, 5), ((), 1, 6), ENUM_LARGE)
ENUM_BWD_RTOL = 1e-6  # the backward against its plain version
# enum_chain checks, (T, batch, K): the main path's chain, T = 2 and 1,
# chains across the warp/CTA split (K = 32 | 33) and the CTA kernels'
# whole-matrix/row-chunk split (K = 128 | 257; 128 in float64 chunks too),
# batched, broadcast from a (K,) alpha0 and masked; the large timing shape
CHAIN_MAIN, CHAIN_LARGE = (ENUM_T, (), ENUM_K), (ENUM_T, (4096,), 64)
CHAIN_SHAPES = (CHAIN_MAIN, (2, (), 8), (1, (), 8), (40, (), 3), (9, (), 1),
                (5, (), 32), (5, (), 33), (4, (), 128), (3, (), 257),
                (12, (4,), 8), (7, (2, 3), 5), (6, (3,), 40), (7, (2,), 9),
                (5, (), 16))
# the ensemble samplers: ChEES at benchmarks/chees.py's 8-chain point
# (300 warmup iterations) with 1500 draws, not 300: on this data its warmup
# leaves a short trajectory (~1.5, ~0.1 effective draws per draw at the
# worst coordinate), and at 300 draws split R-hat exceeds 1.01 for the JAX
# package itself (1.03 in two seeds; PERF.md); MALA and RWM at 16 chains
# (RWM warm-started at MALA's posterior mean)
CHEES_CHAINS, CHEES_WARMUP, CHEES_DRAWS = 8, 300, 1500
MRW_CHAINS, MRW_WARMUP, MRW_DRAWS = 16, 500, 500
RHAT_MAX = 1.01  # tests/test_ensemble.py:144's gate
# batch leapfrog and MALA/RWM checks: the main paths' ensembles, ragged
# ones, and the large timing shape
ENS_CHEES, ENS_MRW, ENS_LARGE = (CHEES_CHAINS, D), (MRW_CHAINS, D), \
    (64, 1_000_003)
ENS_SHAPES = (ENS_CHEES, ENS_MRW, (1, 1), (3, 130), (5, 4097), ENS_LARGE)
# SKIM at benchmarks/skim.py:17's largest p and its --quick warmup: p = 256
# features (D = p + 4 latents), n = 200 rows, 3 planted interactions,
# NUTS at max_tree_depth 8, at most 1 % of draws divergent; the draws cut
# from the --quick 100 to 50 (the first 50 of the same chain; ~23 s at
# ~7.4 ms a leapfrog, 63 a transition) to make room for the svi phase.  Its
# profile in a fresh process (~33 s on a slow host) went to make room for
# the mesh phase: 60 + 30 took as many leapfrogs (16,130 against 17,395;
# shorter warmup, smaller steps) and saved nothing
SKIM_P, SKIM_N, SKIM_INTER = 256, 200, 3
SKIM_WARMUP, SKIM_DRAWS = 100, 50
SKIM_DIVERGENT_MAX = 0.01
# eight schools, non-centered by LocScaleReparam: NUTS, 4 chains in
# lockstep, the example's 150 warmup (examples/eight_schools.py:43) and 100
# of its 200 draws (cut to make room for the svi phase: ~18 s; split R-hat
# was 1.0065 at 200), split R-hat under the example's cut (:99)
ES_CHAINS, ES_WARMUP, ES_DRAWS = 4, 150, 100
ES_RHAT_MAX = 1.05
# the NUTS leaf ops: the main paths' D (logreg, the enumerated HMM, the
# semi-supervised HMM, SKIM), ragged ones and a large one (264 CTAs and the
# ticket fold); leaf kinds (r_sum given, ckpt_i, (idx_min, idx_max)): a
# subtree's first leaf, an even leaf, odd leaves with 1, 3 and 6 checkpoint
# rows (6 takes two passes); timed: an odd leaf with one row (an odd leaf
# reads one on average) at the logreg's D
NUTS_SIZES = (D, 176, 33, SKIM_P + 4, 1, 4097, 1_000_003)
NUTS_LEAVES = ((False, 0, None), (True, 3, None), (True, None, (4, 4)),
               (True, None, (0, 2)), (True, None, (1, 6)))
NUTS_TIMED = (True, None, (2, 2))
FUSED_REL_TOL = 1e-6  # a fused sum against the plain one, of its |terms|
# lockstep NUTS over C chains: the chain-batched leaf ops at C chains and D
# of the logreg (54), eight schools (10), SKIM (260) and 4097 (5 CTAs a
# chain and the per-chain ticket fold), every leaf kind of NUTS_LEAVES,
# active and inactive chains, both directions; timed at C = 8, D = 54
NUTS_BATCH_CHAINS = (1, 4, 8, 16)
NUTS_BATCH_SIZES = (D, 10, SKIM_P + 4, 4097)
# the vectorized logreg: 8 chains in lockstep, 100 + 100 (the single
# chain's draws; at 100 + 50 split R-hat was 1.067), split R-hat under the
# example's 1.05; the first
# VEC_DEPART_TRANSITIONS transitions of each chain against a lone run of
# its seed (printed, not gated); a 4-transition profile in a fresh process
VEC_CHAINS, VEC_WARMUP, VEC_DRAWS = 8, 100, 100
VEC_RHAT_MAX = 1.05
VEC_DEPART_TRANSITIONS = 20
VEC_PROFILE_TRANSITIONS = 4
# cross-chain mass adaptation: tests/test_ensemble.py:186's conjugate
# normal model, 4 chains, 300 + 400, its bounds
XCHAIN_CHAINS, XCHAIN_WARMUP, XCHAIN_DRAWS = 4, 300, 400
# dense mass: tests/test_mcmc.py:191's correlated Gaussian (rho = 0.95),
# one chain, 300 + 300
DENSE_RHO, DENSE_WARMUP, DENSE_DRAWS = 0.95, 300, 300
# the LM slice: the full Qwen3-8B, B = 4 prompts of 512 tokens (a multiple
# of the JAX prefill's 128-row tiles), 32 sampled tokens
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 512, 32
LM_PREFILL_REPS = 3
# prefill's last logits against the teacher-forced decode logits at P - 1,
# relative rms error: both run the same bf16 model, but the prefill's
# (2048 x d) products and the decode's (4 x d) ones sum in other orders, so
# every bf16-rounded activation may differ by a rounding step (2**-8
# relative); ~10 rounded values per layer over 36 layers compound to a few
# per cent.  A wrong position, mask or cache slot decorrelates the logits
# (relative error ~1).
LM_REL_RMS_MAX = 0.15
# the 2-layer float32 model (its prefill, and LM_F32_DECODE_STEPS decode
# steps) through the kernels against the plain versions: the products are the same cuBLAS calls in both runs, so only the kernels'
# float32 rounding (~1e-7 relative) differs; 1e-4 of the largest logit
LM_F32_REL_TOL = 1e-4
LM_F32_DECODE_STEPS = 8
# rmsnorm checks: the rows of Qwen3-8B's block norms at prefill (timed: the
# main shape first) and decode, its q/k-norm rows, and ragged ones
RMS_TIMED = ((LM_BATCH * LM_PROMPT, 4096), (LM_BATCH * LM_PROMPT * 32, 128),
             (LM_BATCH, 4096))
RMS_SHAPES = RMS_TIMED + ((LM_BATCH * LM_PROMPT * 8, 128), (LM_BATCH * 32, 128),
                          (LM_BATCH * 8, 128), (7, 96), (1, 1), (3, 5, 4097))
# the cold timing rotates its input over copies holding this many bytes:
# three times the H100's 50 MB L2
COLD_BYTES = 150 * 10 ** 6
# attention checks (B, S, H, K, dq, dv, causal): Qwen3-8B's prefill (timed),
# bidirectional, ragged S with GQA and MHA, MLA-shaped dq != dv, MQA,
# gemma's head dim 256, and a sequence shorter than one tile
ATTN_MAIN = (LM_BATCH, LM_PROMPT, 32, 8, 128, 128, True)
ATTN_SHAPES = (ATTN_MAIN, (LM_BATCH, LM_PROMPT, 32, 8, 128, 128, False),
               (2, 200, 4, 2, 64, 64, True), (2, 200, 4, 4, 64, 64, False),
               (1, 130, 4, 4, 192, 128, True), (2, 96, 8, 1, 64, 64, True),
               (1, 64, 2, 1, 256, 256, True), (3, 7, 2, 2, 32, 16, False))


# the training slice: the full gemma-2b (bf16, remat "full", AdamW), B = 4
# sequences of 1024 tokens in 2 microbatches, 8 steps on one fixed batch (the
# loss must fall as the batch is memorized, as tests/test_archs_smoke.py:61
# asks of the JAX package), then the launcher for 2 steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "gemma-2b", 4, 1024
TRAIN_MICROBATCHES, TRAIN_STEPS, TRAIN_LAUNCHER_STEPS = 2, 8, 2
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
MB_ROWS = TRAIN_BATCH // TRAIN_MICROBATCHES * TRAIN_SEQ  # rows per microbatch
# a full-width 2-layer float32 gemma's loss and every gradient leaf through
# the kernels against the plain versions: 1e-4 of the largest |grad|
TRAIN_F32_LAYERS, TRAIN_F32_REL_TOL = 2, 1e-4
# rmsnorm backward checks: gemma's block-norm rows per microbatch (timed),
# Qwen3's q-norm rows, ragged ones
RMS_BWD_MAIN = (MB_ROWS, 2048)
RMS_BWD_SHAPES = (RMS_BWD_MAIN, (LM_BATCH * LM_PROMPT * 32, 128),
                  (LM_BATCH * LM_PROMPT, 4096), (7, 96), (1, 1), (3, 5, 4097))
# flash-attention backward checks (B, S, H, K, dq, dv, causal): gemma's
# microbatch (MQA, head dim 256; timed), Qwen3's prefill shape (GQA), the
# forward's ragged, bidirectional, MHA, MLA-shaped and tiny cases
ATTN_BWD_MAIN = (TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, 8, 1, 256,
                 256, True)
ATTN_BWD_SHAPES = (ATTN_BWD_MAIN, ATTN_MAIN) + ATTN_SHAPES[1:]
# softmax_xent checks (T, d, V, tied): gemma's microbatch against its tied
# (V, d) embedding (timed), a Qwen3-shaped (d, V) unembedding with its ragged
# V = 151,936, ragged small ones
XENT_MAIN = (MB_ROWS, 2048, 256000, True)
XENT_SHAPES = (XENT_MAIN, (512, 4096, 151936, False), (37, 24, 301, False),
               (130, 64, 1000, True), (1, 8, 3, True))
# (dlogits, tied) pairs of softmax_xent_bf16_info: each kernel in each layout
XENT_INFO_DIMS = ((0, 1), (0, 0), (1, 1), (1, 0))

# the Mamba-2 slice: the full mamba2-370m (bf16, 48 layers), a prefill of
# B = 4 prompts of 2048 tokens (8 chunks of 256), then the launcher's
# serving loop over B = 4 prompts of 512 and 32 sampled tokens
SSM_ARCH, SSM_BATCH, SSM_PREFILL_LEN = "mamba2-370m", 4, 2048
SSM_PROMPT, SSM_TOKENS, SSM_PREFILL_REPS = 512, 32, 3
# the 2-layer float32 mamba2 through the kernels against the plain versions:
# its prefill, then SSM_F32_DECODE_STEPS decode steps and their caches
SSM_F32_LAYERS, SSM_F32_DECODE_STEPS, SSM_F32_REL_TOL = 2, 8, 1e-4
# ssd_scan checks (b, l, h, p, g, n, chunk): mamba2-370m's prefill (timed),
# two B/C groups at chunks of 64, one chunk shorter than 256 (l == chunk),
# the reduced model's widths, p not a multiple of the kernel's 32 channels,
# the widest state the kernels take (n = 256)
SSD_MAIN = (SSM_BATCH, SSM_PREFILL_LEN, 32, 64, 1, 128, 256)
SSD_SHAPES = (SSD_MAIN, (2, 512, 32, 64, 2, 128, 64),
              (2, 200, 8, 64, 1, 128, 200), (2, 64, 16, 16, 1, 16, 32),
              (1, 96, 4, 40, 2, 24, 32), (1, 128, 4, 32, 1, 256, 64))
SSD_BWD_SHAPE = (2, 128, 4, 16, 2, 32, 64)  # the SsdScan backward, float32
# the rmsnorm checks also cover mamba2-370m's block-norm rows at its prefill
# and at a decode step
RMS_SHAPES += ((SSM_BATCH * SSM_PREFILL_LEN, 1024), (SSM_BATCH, 1024))


# the bf16 tensor-core kernels: library -> [(kernel function as cuobjdump
# names it, the C function that reports its dynamic shared memory and CTAs
# per SM at two given dims, what those dims are, their values)]: the
# attention kernels at Qwen3-8B's and gemma-2b's head dims, the scan at
# mamba2-370m's (p = 64, n = 128) and at the other two instantiations', the
# xent kernels in both weight layouts
_HEAD_DIMS = ("dq = dv", ((128, 128), (256, 256)))
TC_KERNELS = {"flash_attention": [("flash_fwd_tc_kernel",
                                   "flash_attention_fwd_bf16_info",
                                   *_HEAD_DIMS)],
              "flash_attention_bwd": [("dkv_tc_kernel",
                                       "flash_attention_dkv_bf16_info",
                                       *_HEAD_DIMS),
                                      ("dq_tc_kernel",
                                       "flash_attention_dq_bf16_info",
                                       *_HEAD_DIMS)],
              "ssd_scan": [("ssd_tc_kernel", "ssd_scan_bf16_info", "p, n",
                            ((64, 128), (64, 16), (64, 256)))],
              "softmax_xent": [("xent_fwd_tc_kernel", "softmax_xent_bf16_info",
                                "dlogits, tied", XENT_INFO_DIMS[:2]),
                               ("dlogits_tc_kernel", "softmax_xent_bf16_info",
                                "dlogits, tied", XENT_INFO_DIMS[2:])]}


def _cuobjdump(flag, path):
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, flag, str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def kernel_usage(path, func):
    """Registers, static shared memory, stack and local (spill) bytes of
    each instantiation of kernel ``func`` in the library at ``path``
    (``cuobjdump -res-usage``) and its count of tensor-core instructions
    (``HGMMA``/``HMMA``, ``cuobjdump -sass``), keyed ``func<args>``."""
    import re
    usage, current = {}, None
    for line in _cuobjdump("-res-usage", path).splitlines():
        found = re.search(r"Function (\S+):", line)
        if found:
            current = found.group(1) if func in found.group(1) else None
        elif current and "REG:" in line:
            args = ",".join(
                v if t == "i" else ("false", "true")[int(v)]
                for t, v in re.findall(r"L([ib])(\d+)E", current))
            key = f"{func}<{args}>"
            usage[key] = {k: int(v) for k, v in
                          re.findall(r"(\w+):(\d+)", line)
                          if k in ("REG", "STACK", "SHARED", "LOCAL")}
            usage[key]["mangled"] = current
    current = None
    for line in _cuobjdump("-sass", path).splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = next((k for k, u in usage.items()
                            if u["mangled"] == found.group(1)), None)
            if current:
                usage[current].update(HGMMA=0, HMMA=0)
        elif current:
            for op in ("HGMMA", "HMMA"):
                usage[current][op] += bool(re.search(rf"\b{op}\.", line))
    for u in usage.values():
        del u["mangled"]
    return usage


def kernel_at_dims(lib, info, dims=((128, 128), (256, 256))):
    """Dynamic shared memory and resident CTAs per SM of a tensor-core
    kernel at each pair of dims (dq, dv for the attention kernels, p, n for
    the scan), from its library's ``info`` export, keyed ``"a, b"``."""
    import ctypes
    fn = getattr(lib, info)
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    out = {}
    for a, b in dims:
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        rc = fn(a, b, ctypes.byref(smem), ctypes.byref(ctas))
        check(rc == 0, f"{info}({a}, {b}) failed: cudaError {rc}")
        out[f"{a}, {b}"] = {"dynamic_smem_bytes": smem.value,
                            "ctas_per_sm": ctas.value}
    return out


def tc_kernel_usage():
    """:func:`kernel_usage` of every bf16 tensor-core kernel on the built
    libraries; fails unless each kernel is there and every instantiation
    has at least one tensor-core instruction.  Beside them, each kernel's
    dynamic shared memory and resident CTAs per SM at the dims
    ``TC_KERNELS`` names."""
    from repro_torch.kernels import _build
    usage, at_dims = {}, {}
    for lib, kernels in TC_KERNELS.items():
        path = _build.library_path(lib)
        for func, info, label, dims in kernels:
            for ab, u in kernel_at_dims(_build.load(lib), info,
                                        dims).items():
                at_dims[f"{func} at {label} = {ab}"] = u
            found = kernel_usage(path, func)
            check(found, f"cuobjdump found no {func} in {path.name}")
            usage.update(found)
    for key, u in usage.items():
        check(u.get("HGMMA", 0) + u.get("HMMA", 0) > 0,
              f"{key} has no tensor-core instruction: {u}")
    return {"instantiations": usage, "at_head_dims": at_dims}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def call_ms(fn, iters):
    """Time per call of ``fn`` called eagerly from Python (CUDA events): the
    host's enqueue cost is in it whenever it exceeds the device's work."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, reps=5):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events, so no host cost is
    in the reading."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _replay_ms(graph, iters, reps)


def backward_device_ms(forward, inputs, grad, iters, reps=5):
    """Device time per backward of ``forward(*inputs)`` (leaves that require
    grad) for the output gradient ``grad``: the forward runs once on a side
    stream, so autograd runs its backward on that stream too; ``iters``
    ``torch.autograd.grad`` calls of that one output are then captured in
    one CUDA graph on the same stream and replayed as in :func:`device_ms`,
    so no host cost is in the reading."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*inputs)

    def backward():
        return torch.autograd.grad(out, inputs, grad, retain_graph=True)

    with torch.cuda.stream(side):
        backward()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            backward()
    torch.cuda.current_stream().wait_stream(side)
    return _replay_ms(graph, iters, reps)


def _replay_ms(graph, iters, reps):
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def timings(kernel, plain, iters):
    return {"ms": device_ms(kernel, iters), "plain_ms": device_ms(plain, iters),
            "call_ms": call_ms(kernel, 10 * iters),
            "plain_call_ms": call_ms(plain, iters)}


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_peak(dev):
    """Reset the peak-memory counter for one measured run, after freeing
    the cuBLAS and cuBLASLt workspaces (one cached per stream) that earlier
    phases left on their timing and capture streams: the run's peak then
    counts what the run itself allocates, its own workspaces included (as
    PyTorch's leak checks clear them before counting)."""
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.reset_peak_memory_stats(dev)


def check(cond, message):
    if not cond:
        raise RuntimeError(message)


def leapfrog_checks(dev):
    """Row 1's kernel against its plain version (D = 54 float32, 1,000,003
    float32 and float64), timed at D = 54; then the NUTS leaf ops fused
    around it (``nuts_fused_checks``).  Returns the checks, the kernel's
    timing and the fused ops' timings."""
    from repro_torch.kernels.leapfrog import (leapfrog_halfstep_cuda,
                                              leapfrog_halfstep_ref)
    tol = 1e-6  # OP_TABLE's bound: one rounding of the same arithmetic
    results, timing = [], None
    for size, dtype in ((D, torch.float32), (1_000_003, torch.float32),
                        (1_000_003, torch.float64)):
        gen = torch.Generator().manual_seed(size)
        z, r, g = (torch.randn(size, generator=gen, dtype=dtype).to(dev)
                   for _ in range(3))
        m_inv = (torch.rand(size, generator=gen, dtype=dtype) + 0.5).to(dev)
        eps = torch.tensor(-0.0123, dtype=dtype, device=dev)
        got = leapfrog_halfstep_cuda(z, r, g, m_inv, eps)
        want = leapfrog_halfstep_ref(z, r, g, m_inv, eps)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        results.append({"D": size, "dtype": str(dtype), "max_abs_err": err,
                        "tol": tol})
        check(err <= tol, f"leapfrog kernel disagrees at D={size} {dtype}: "
                          f"{err} > {tol}")
        if size == D:  # the main path's shape
            itemsize = torch.tensor([], dtype=dtype).element_size()
            timing = (timings(
                lambda: leapfrog_halfstep_cuda(z, r, g, m_inv, eps),
                lambda: leapfrog_halfstep_ref(z, r, g, m_inv, eps), 200),
                bound((6 * size + 1) * itemsize, 5 * size, dtype), err)
    fused, fused_timing = nuts_fused_checks(dev)
    return results + fused, timing, fused_timing


def same_bits(a, b):
    """Bit-identical, NaN included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _nuts_operands(size, dtype, dev):
    gen = torch.Generator().manual_seed(size)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=dtype)).to(dev)

    r_half, z, g, r_sum = (rand(size) for _ in range(4))
    m_inv = (torch.rand(size, generator=gen, dtype=dtype) + 0.5).to(dev)
    ck, sck = rand(8, size), rand(8, size, scale=2.0)
    pe = torch.tensor(1.75, dtype=dtype, device=dev)
    eps = torch.tensor(-0.0123, dtype=dtype, device=dev)
    return r_half, z, g, r_sum, m_inv, ck, sck, pe, eps


def leaf_scales(m, want, ck, sck, rows):
    """Each sum of a leaf's values, ke and the dots, as the sum of its
    terms' magnitudes (the scale of the fused sums' tolerance)."""
    r, through = want[0], want[1]
    scales = [float((r * (m * r)).abs().sum())]
    if rows is not None:
        rc = ck[rows[0]:rows[1] + 1]
        mid = (through - sck[rows[0]:rows[1] + 1] + rc) - 0.5 * (rc + r)
        scales += (m * rc * mid).abs().sum(-1).tolist()
        scales += (m * r * mid).abs().sum(-1).tolist()
    return torch.tensor(scales, dtype=torch.float64)


def nuts_fused_checks(dev):
    """``nuts_leaf`` and ``nuts_turning`` against their plain versions on
    every size of ``NUTS_SIZES`` and leaf kind of ``NUTS_LEAVES``, float32
    and float64: the vectors and checkpoint rows bit-identical, pe copied,
    ke and the dots within FUSED_REL_TOL of their terms' magnitudes, a
    repeated call bit-identical; timings at the logreg's D."""
    from repro_torch.kernels.leapfrog import (nuts_leaf_cuda, nuts_leaf_ref,
                                              nuts_turning_cuda,
                                              nuts_turning_ref)
    results, timing = [], {}
    for size in NUTS_SIZES:
        for dtype in (torch.float32, torch.float64):
            r_half, z, g, r_sum, m, ck, sck, pe, eps = \
                _nuts_operands(size, dtype, dev)
            for has_sum, ckpt_i, rows in NUTS_LEAVES:
                args = (r_half, z, g, pe, m, eps, r_sum if has_sum else None)
                idx = rows or (0, -1)
                ck_k, sck_k, ck_p, sck_p = (t.clone() for t in
                                            (ck, sck, ck, sck))
                got = nuts_leaf_cuda(*args, ck_k, sck_k, ckpt_i, *idx)
                again = nuts_leaf_cuda(*args, ck.clone(), sck.clone(),
                                       ckpt_i, *idx)
                want = nuts_leaf_ref(*args, ck_p, sck_p, ckpt_i, *idx)
                torch.cuda.synchronize()
                pairs = [(got[i], want[i]) for i in (0, 1, 3, 4)] + \
                    [(ck_k, ck_p), (sck_k, sck_p)]
                identical = all(same_bits(a, b) for a, b in pairs) and \
                    float(got[2][0]) == float(want[2][0])
                repeat = all(same_bits(a, b) for a, b in zip(
                    (got[0], got[1], got[2], got[3], got[4]), again))
                diff = (got[2][1:].double() - want[2][1:].double()).abs()
                rel = float((diff.cpu() / leaf_scales(
                    m, want, ck, sck, rows).clamp(min=1e-300)).max())
                err = max(float((a.double() - b.double()).abs().max())
                          for a, b in pairs + [(got[2], want[2])])
                kind = "first" if not has_sum else (
                    f"even, row {ckpt_i}" if rows is None
                    else f"odd, rows {rows[0]}..{rows[1]}")
                results.append({"name": "nuts_leaf", "D": size,
                                "dtype": str(dtype), "leaf": kind,
                                "vectors_bit_identical": identical,
                                "repeat_bit_identical": repeat,
                                "sums_rel_err": rel, "max_abs_err": err})
                check(identical and repeat and rel <= FUSED_REL_TOL,
                      f"nuts_leaf disagrees at D={size} {dtype} ({kind}): "
                      f"bit-identical {identical}, repeat {repeat}, sums "
                      f"{rel} > {FUSED_REL_TOL} of their terms")
            r_left, r_right, total = (r_half, g, 3.0 * r_sum)
            got = nuts_turning_cuda(m, r_left, r_right, total)
            again = nuts_turning_cuda(m, r_left, r_right, total)
            want = nuts_turning_ref(m, r_left, r_right, total)
            mid = total - 0.5 * (r_left + r_right)
            scale = torch.stack([(m * r_left * mid).abs().sum(),
                                 (m * r_right * mid).abs().sum()]).double()
            diff = (got.double() - want.double()).abs()
            rel = float((diff / scale).max())
            repeat = same_bits(got, again)
            results.append({"name": "nuts_turning", "D": size,
                            "dtype": str(dtype), "sums_rel_err": rel,
                            "repeat_bit_identical": repeat,
                            "max_abs_err": float(diff.max())})
            check(repeat and rel <= FUSED_REL_TOL,
                  f"nuts_turning disagrees at D={size} {dtype}: repeat "
                  f"{repeat}, {rel} > {FUSED_REL_TOL} of its terms")
            if size == D and dtype == torch.float32:
                has_sum, ckpt_i, rows = NUTS_TIMED
                args = (r_half, z, g, pe, m, eps, r_sum, ck, sck, ckpt_i,
                        *rows)
                leaf_err = max(c["max_abs_err"] for c in results
                               if c["name"] == "nuts_leaf")
                timing["nuts_leaf"] = (
                    timings(lambda: nuts_leaf_cuda(*args),
                            lambda: nuts_leaf_ref(*args), 200),
                    nuts_leaf_bound(size, rows[1] - rows[0] + 1, has_sum,
                                    ckpt_i is not None, dtype), leaf_err)
                timing["nuts_turning"] = (
                    timings(lambda: nuts_turning_cuda(m, r_left, r_right,
                                                      total),
                            lambda: nuts_turning_ref(m, r_left, r_right,
                                                     total), 200),
                    bound(dtype.itemsize * (4 * size + 2), 9 * size, dtype),
                    float(diff.max()))
    return results, timing


def nuts_leaf_bound(d, rows, has_sum, even, dtype):
    """Bytes: r_half, z, g, m_inv (and r_sum) and two checkpoint rows per
    dot row read, r, z_next, r_half_next (and r_sum_through) and an even
    leaf's two checkpoint rows written, once each, plus eps, pe and the
    packed values.  Operations per element: 9 (closing kick 2, ke 3, the
    next kick 1 and drift 3), 1 for r_sum, and with dot rows 1 + 10 a row."""
    vectors = 4 + 3 + 2 * rows + 2 * int(has_sum) + 2 * int(even)
    nbytes = dtype.itemsize * (vectors * d + 2 + 2 + 2 * rows)
    flops = (9 + int(has_sum) + (1 + 10 * rows if rows else 0)) * d
    return bound(nbytes, flops, dtype)


def _batch_operands(c, size, dtype, dev):
    """(C, D) operands of the chain-batched leaf ops: per-chain step sizes
    signed for a mix of directions, and a mix of active chains."""
    gen = torch.Generator().manual_seed(1000 * c + size)

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen,
                                    dtype=dtype)).to(dev)

    r_half, z, g, r_sum = (rand(c, size) for _ in range(4))
    m_inv = (torch.rand(c, size, generator=gen, dtype=dtype) + 0.5).to(dev)
    ck, sck = rand(c, 8, size), rand(c, 8, size, scale=2.0)
    pe = rand(c)
    chains = torch.arange(c)
    eps = torch.where(chains % 2 == 0, 1.0, -1.0) * 0.0123 * (1 + 0.1 * chains)
    active = chains % 3 != 1 if c > 1 else torch.ones(1, dtype=torch.bool)
    return (r_half, z, g, r_sum, m_inv, ck, sck, pe, eps.to(dtype).to(dev),
            active.to(dev))


def nuts_batch_checks(dev, chains=NUTS_BATCH_CHAINS, sizes=NUTS_BATCH_SIZES,
                      timed=True):
    """``nuts_leaf_batch``, ``nuts_turning_batch`` and ``halfstep_chains``
    against their plain versions for C in ``NUTS_BATCH_CHAINS``, D in
    ``NUTS_BATCH_SIZES``, float32 and float64, every leaf kind of
    ``NUTS_LEAVES``, active and inactive chains, both directions: vectors
    and checkpoint rows bit-identical (an inactive chain copied through),
    ke and the dots within FUSED_REL_TOL of their terms; each active row's
    vectors bit-identical to a one-chain ``nuts_leaf`` launch on that chain
    (its sums' identity reported); the half-step bit-identical.  Timings
    at C = 8, D = 54, every chain active (unless ``timed`` is false)."""
    from repro_torch.kernels.leapfrog import (
        halfstep_chains_cuda, halfstep_chains_ref, nuts_leaf_batch_cuda,
        nuts_leaf_batch_ref, nuts_leaf_cuda, nuts_turning_batch_cuda,
        nuts_turning_batch_ref, nuts_turning_cuda)
    results, timing = [], {}
    for c in chains:
        for size in sizes:
            for dtype in (torch.float32, torch.float64):
                (r_half, z, g, r_sum, m, ck, sck, pe, eps,
                 active) = _batch_operands(c, size, dtype, dev)
                on = [i for i, a in enumerate(active.tolist()) if a]
                for has_sum, ckpt_i, rows in NUTS_LEAVES:
                    args = (r_half, z, g, pe, m, eps, active,
                            r_sum if has_sum else None)
                    idx = rows or (0, -1)
                    ck_k, sck_k, ck_p, sck_p = (t.clone() for t in
                                                (ck, sck, ck, sck))
                    got = nuts_leaf_batch_cuda(*args, ck_k, sck_k, ckpt_i,
                                               *idx)
                    want = nuts_leaf_batch_ref(*args, ck_p, sck_p, ckpt_i,
                                               *idx)
                    torch.cuda.synchronize()
                    pairs = [(got[i], want[i]) for i in (0, 1, 3, 4)] + \
                        [(ck_k, ck_p), (sck_k, sck_p)]
                    identical = all(same_bits(a, b) for a, b in pairs) and \
                        same_bits(got[2][:, 0], want[2][:, 0])
                    off = [i for i in range(c) if i not in on]
                    identical &= all(same_bits(got[2][i], want[2][i])
                                     for i in off)
                    rel, one_vec, one_sums = 0.0, True, True
                    for i in on:
                        w_i = tuple(t[i] for t in want)
                        diff = (got[2][i, 1:].double()
                                - want[2][i, 1:].double()).abs()
                        rel = max(rel, float((diff.cpu() / leaf_scales(
                            m[i], w_i, ck[i], sck[i], rows).clamp(
                                min=1e-300)).max()))
                        ck_1, sck_1 = ck[i].clone(), sck[i].clone()
                        one = nuts_leaf_cuda(
                            r_half[i], z[i], g[i], pe[i], m[i], eps[i],
                            r_sum[i] if has_sum else None, ck_1, sck_1,
                            ckpt_i, *idx)
                        one_vec &= all(same_bits(one[k], got[k][i])
                                       for k in (0, 1, 3, 4)) and \
                            same_bits(ck_1, ck_k[i]) and \
                            same_bits(sck_1, sck_k[i])
                        one_sums &= same_bits(one[2], got[2][i])
                    err = max(float((a.double() - b.double()).abs().max())
                              for a, b in pairs + [(got[2], want[2])])
                    kind = "first" if not has_sum else (
                        f"even, row {ckpt_i}" if rows is None
                        else f"odd, rows {rows[0]}..{rows[1]}")
                    results.append({
                        "name": "nuts_leaf_batch", "C": c, "D": size,
                        "dtype": str(dtype), "leaf": kind,
                        "active": len(on), "vectors_bit_identical": identical,
                        "one_chain_vectors_bit_identical": one_vec,
                        "one_chain_sums_bit_identical": one_sums,
                        "sums_rel_err": rel, "max_abs_err": err})
                    check(identical and one_vec and rel <= FUSED_REL_TOL,
                          f"nuts_leaf_batch disagrees at C={c} D={size} "
                          f"{dtype} ({kind}): bit-identical {identical}, "
                          f"one-chain {one_vec}, sums {rel} > "
                          f"{FUSED_REL_TOL} of their terms")
                total = 3.0 * r_sum
                got = nuts_turning_batch_cuda(m, r_half, g, total)
                want = nuts_turning_batch_ref(m, r_half, g, total)
                mid = total - 0.5 * (r_half + g)
                scale = torch.stack([(m * r_half * mid).abs().sum(-1),
                                     (m * g * mid).abs().sum(-1)], 1).double()
                diff = (got.double() - want.double()).abs()
                rel = float((diff / scale).max())
                one = all(same_bits(nuts_turning_cuda(m[i], r_half[i], g[i],
                                                      total[i]), got[i])
                          for i in range(c))
                results.append({"name": "nuts_turning_batch", "C": c,
                                "D": size, "dtype": str(dtype),
                                "sums_rel_err": rel,
                                "one_chain_bit_identical": one,
                                "max_abs_err": float(diff.max())})
                check(rel <= FUSED_REL_TOL, f"nuts_turning_batch disagrees "
                      f"at C={c} D={size} {dtype}: {rel} > {FUSED_REL_TOL}")
                got = halfstep_chains_cuda(z, r_half, g, m, eps, active)
                want = halfstep_chains_ref(z, r_half, g, m, eps, active)
                ok = all(same_bits(a, b) for a, b in zip(got, want))
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                results.append({"name": "halfstep_chains", "C": c, "D": size,
                                "dtype": str(dtype), "bit_identical": ok,
                                "max_abs_err": err})
                check(ok, f"halfstep_chains disagrees at C={c} D={size} "
                      f"{dtype}: {err}")
                if timed and (c, size, dtype) == (VEC_CHAINS, D,
                                                  torch.float32):
                    timing.update(nuts_batch_timings(
                        c, size, dtype, (r_half, z, g, r_sum, m, ck, sck, pe,
                                         eps), results))
    return results, timing


def nuts_batch_timings(c, d, dtype, operands, results):
    """Kernel and plain times of the chain-batched ops at (c, d), every
    chain active (the plain versions read a host mask: a capture cannot
    wait for the card), beside their bounds."""
    from repro_torch.kernels.leapfrog import (
        halfstep_chains_cuda, halfstep_chains_ref, nuts_leaf_batch_cuda,
        nuts_leaf_batch_ref, nuts_turning_batch_cuda, nuts_turning_batch_ref)
    r_half, z, g, r_sum, m, ck, sck, pe, eps = operands
    active = torch.ones(c, dtype=torch.bool, device=z.device)
    host = active.cpu()
    has_sum, ckpt_i, rows = NUTS_TIMED
    leaf = (r_half, z, g, pe, m, eps)
    tail = (r_sum, ck, sck, ckpt_i, *rows)

    def err(name):
        return max(r["max_abs_err"] for r in results if r["name"] == name)

    total = 3.0 * r_sum
    nrows = rows[1] - rows[0] + 1
    item = dtype.itemsize
    return {
        "nuts_leaf_batch": (
            timings(lambda: nuts_leaf_batch_cuda(*leaf, active, *tail),
                    lambda: nuts_leaf_batch_ref(*leaf, host, *tail), 200),
            nuts_leaf_batch_bound(c, d, nrows, has_sum, ckpt_i is not None,
                                  dtype), err("nuts_leaf_batch")),
        "nuts_turning_batch": (
            timings(lambda: nuts_turning_batch_cuda(m, r_half, g, total),
                    lambda: nuts_turning_batch_ref(m, r_half, g, total), 200),
            bound(item * (4 * c * d + 2 * c), 9 * c * d, dtype),
            err("nuts_turning_batch")),
        "halfstep_chains": (
            timings(lambda: halfstep_chains_cuda(z, r_half, g, m, eps,
                                                 active),
                    lambda: halfstep_chains_ref(z, r_half, g, m, eps, host),
                    200),
            bound(item * (6 * c * d + c) + c, 5 * c * d, dtype),
            err("halfstep_chains"))}


def nuts_leaf_batch_bound(c, d, rows, has_sum, even, dtype):
    """C chains of :func:`nuts_leaf_bound`'s leaf (each chain's m_inv row
    read too), plus each chain's active flag."""
    vectors = 4 + 3 + 2 * rows + 2 * int(has_sum) + 2 * int(even)
    nbytes = dtype.itemsize * c * (vectors * d + 2 + 2 + 2 * rows) + c
    flops = c * (9 + int(has_sum) + (1 + 10 * rows if rows else 0)) * d
    return bound(nbytes, flops, dtype)


def mala_accept_bound(variant, c, d, warmup):
    """Bytes of one float32 call: MALA reads z, z', g, g' and the noise,
    RWM z and z', each (C, D) once, plus m_inv, pe, pe', u (and the mean
    after warmup); writes z (and MALA's g), pe, accept_prob, diverging (one
    byte) and the mean or the harmonic mean.  Operations: MALA 9 an element
    (the two sums' terms) and ~15 a chain, RWM ~10 a chain (+ 2 C in
    warmup)."""
    cells = c * d
    if variant == "MALA":
        moved = 7 * cells + d
        flops = 9 * cells + 15 * c
    else:
        moved = 3 * cells
        flops = 10 * c
    small = 5 * c + (1 if warmup else 2 * c)
    return bound(4 * (moved + small) + c, flops + (2 * c if warmup else 0),
                 torch.float32)


def accept_operands(c, d, dtype, seed, dev, variant, eps):
    """A MALA or RWM accept step's operands as the sampler makes them: the
    proposal from ``mala_step_ref`` with standard normal noise, a gradient
    and potential at it near the current ones (so accept_prob is spread
    over (0, 1]); chain 0's proposal potential inf and chain 1's NaN (where
    C >= 3).  Returns the argument tuple of ``mala_accept`` but for ``coef``,
    ``mean_accept_prob`` and ``n_post``, and the mean."""
    from repro_torch.kernels.rwm_mala import mala_step_ref
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)

    z, grad, noise = rand(c, d), rand(c, d), rand(c, d)
    m = torch.rand(d, generator=gen, dtype=dtype) + 0.5
    mala = variant == "MALA"
    z_new = mala_step_ref(z, grad if mala else None, noise, m, eps)
    grad_new = grad + 0.2 * rand(c, d)
    pe = 3.0 * rand(c).abs()
    pe_new = pe + 0.5 * rand(c)
    if c >= 3:
        pe_new[0], pe_new[1] = float("inf"), float("nan")
    u, mean = (torch.rand(c, generator=gen, dtype=dtype) for _ in range(2))
    z, grad, noise, m, z_new, grad_new, pe, pe_new, u, mean = (
        t.to(dev) for t in (z, grad, noise, m, z_new, grad_new, pe, pe_new,
                            u, mean))
    if not mala:
        grad = grad_new = noise = None
    return (z, pe, grad, z_new, pe_new, grad_new, noise, m, u), mean


def accept_prob_tolerance(args, eps, coef):
    """The bound on |kernel - plain| of each chain's accept_prob that the
    sums' FUSED_REL_TOL allows: log_accept may move by FUSED_REL_TOL of the
    magnitudes summed into it (|pe|, |pe'|, and MALA's two sums of
    non-negative terms), so accept_prob by that factor of itself.  A
    divergent chain's (pe' not finite) accept_prob is 0 exactly.  The
    magnitudes are ``mala_accept_scale``'s, the ``mala_accept`` registry
    row's scale."""
    from repro_torch.kernels.rwm_mala import mala_accept_scale
    return torch.expm1(FUSED_REL_TOL * mala_accept_scale(*args, eps, coef))


def mala_accept_checks(dev):
    """``mala_accept`` against its plain version on every shape of
    ``ENS_SHAPES``, float32 and float64, MALA and RWM, in warmup and after,
    chain 0's proposal potential inf and chain 1's NaN (where C >= 3):
    the divergences equal, accept_prob within what the sums' FUSED_REL_TOL
    allows (``accept_prob_tolerance``), the same accept choices, the
    selections bit-identical to the plain selection from the kernel's
    accept_prob, as are the running mean and the harmonic mean, a repeated
    call bit-identical; timings at the MALA/RWM path's (16, 54) in
    float32."""
    from repro_torch.kernels.rwm_mala import (harmonic_mean_accept,
                                              mala_accept_cuda,
                                              mala_accept_ref)
    results, timing = [], {}
    eps = 0.0071
    coef = float(np.float32(-0.25) / np.float32(eps))
    for dtype in (torch.float32, torch.float64):
        for seed, (c, d) in enumerate(ENS_SHAPES):
            for variant in ("MALA", "RWM"):
                base, mean = accept_operands(c, d, dtype, seed, dev, variant,
                                             eps)
                z, pe, grad, z_new, pe_new, grad_new, noise, m, u = base
                tol = accept_prob_tolerance(base, eps, coef)
                for n_post in (0, 7):
                    args = base + (eps, coef, mean, n_post)
                    got = mala_accept_cuda(*args)
                    again = mala_accept_cuda(*args)
                    want = mala_accept_ref(*args)
                    torch.cuda.synchronize()
                    ap = got[3]
                    both_nan = ap.isnan() & want[3].isnan()
                    err = torch.where(both_nan, 0.0,
                                      (ap - want[3]).abs()).double()
                    within = bool((err <= tol * torch.maximum(
                        ap, want[3]).double().nan_to_num() + 1e-300).all())
                    acc = u < ap
                    picks = [(got[0], torch.where(acc[:, None], z_new, z)),
                             (got[1], torch.where(acc, pe_new, pe))]
                    if variant == "MALA":
                        picks.append((got[2], torch.where(
                            acc[:, None], grad_new, grad)))
                    stats = (got[5], mean + (ap - mean) / n_post) if n_post \
                        else (got[6], harmonic_mean_accept(ap))
                    identical = all(same_bits(a, b) for a, b in
                                    picks + [stats])
                    same_choice = torch.equal(acc, u < want[3]) and \
                        torch.equal(got[4], want[4])
                    repeat = all(same_bits(a, b) for a, b in zip(
                        got, again) if isinstance(a, torch.Tensor)
                        and a.dtype != torch.bool)
                    phase = "after warmup" if n_post else "warmup"
                    spread = ap[~ap.isnan()]
                    results.append({
                        "name": "mala_accept", "variant": variant,
                        "phase": phase, "shape": [c, d], "dtype": str(dtype),
                        "max_abs_err": float(err.max()),
                        "accept_prob_within_tolerance": within,
                        "accept_prob_range": [float(spread.min()),
                                              float(spread.max())],
                        "selections_bit_identical": identical,
                        "same_choice_as_plain": same_choice,
                        "repeat_bit_identical": repeat})
                    check(within and identical and same_choice and repeat,
                          f"mala_accept ({variant}, {phase}) disagrees at "
                          f"{(c, d)} {dtype}: accept_prob within "
                          f"{within}, selections {identical}, the same "
                          f"choice {same_choice}, repeat {repeat}")
                    if dtype == torch.float32 and (c, d) == ENS_MRW:
                        timing[(variant, phase)] = (
                            timings(lambda a=args: mala_accept_cuda(*a),
                                    lambda a=args: mala_accept_ref(*a), 200),
                            mala_accept_bound(variant, c, d, not n_post),
                            results[-1]["max_abs_err"])
    return results, timing


def glm_checks(dev):
    """The GLM kernel (``glm_chains_kernel``) at the main shape and at (1001,
    7), both families: every chain of 16 within the float64 referee's bound
    as a 1-chain call; for C = 1, 8, 16 (``GLM_CHAINS``: NUTS's, ChEES's and
    MALA/RWM's) chain c of a C-chain call bit-identical to the 1-chain call
    on w_c, repeated calls bit-identical, one launch and C chain
    evaluations a call; device times at the main shape for each C beside
    its bound, max(bytes, operations = n (4 d + 12) C)."""
    from repro_torch.kernels.glm_potential import (glm_potential_grad_cuda,
                                                   glm_potential_grad_ref)
    results, timing = [], {}
    cmax = max(GLM_CHAINS)
    for n, d in ((N, D), (1001, 7)):
        for family, scale in (("bernoulli_logit", None), ("normal", 0.7)):
            gen = torch.Generator().manual_seed(n + d)
            x = torch.randn((n, d), generator=gen).to(dev)
            w_all = (0.3 * torch.randn((cmax, d), generator=gen)).to(dev)
            off = (0.2 * torch.randn(n, generator=gen)).to(dev)
            if family == "bernoulli_logit":
                y = (torch.rand(n, generator=gen) < 0.5).float().to(dev)
            else:
                y = x @ w_all[0] + 0.5 * torch.randn(n, generator=gen).to(dev)
            singles = [glm_potential_grad_cuda(x, y, w_all[c], off, scale,
                                               family) for c in range(cmax)]
            xd = x.double()
            err_v = err_g = worst = 0.0
            for c, (kv, kg) in enumerate(singles):
                # the referee: the same formula in float64
                pv, pg = glm_potential_grad_ref(
                    x, y, w_all[c].double(), off, scale, family,
                    compute_dtype=torch.float64)
                # float32 sums over n rows in another order: the error
                # scales with the sum of the magnitudes of the summed terms
                logits = xd @ w_all[c].double() + off.double()
                if family == "bernoulli_logit":
                    resid = torch.sigmoid(logits) - y.double()
                    terms = torch.nn.functional.softplus(logits) \
                        - y.double() * logits
                else:
                    resid = (logits - y.double()) / scale ** 2
                    terms = 0.5 * ((logits - y.double()) / scale) ** 2 \
                        + math.log(scale)
                g_scale = (resid.abs()[:, None] * xd.abs()).sum(0)
                tol_v = 5e-3 + GLM_REL_TOL * float(terms.abs().sum())
                tol_g = 5e-3 + GLM_REL_TOL * g_scale
                ev = abs(float(kv) - float(pv))
                eg = (kg.double() - pg).abs()
                check(ev <= tol_v and bool((eg <= tol_g).all()),
                      f"GLM kernel disagrees at n={n} d={d} {family} chain "
                      f"{c}: nll err {ev} (tol {tol_v}), grad err "
                      f"{float(eg.max())}")
                err_v, err_g = max(err_v, ev), max(err_g, float(eg.max()))
                worst = max(worst, ev / tol_v, float((eg / tol_g).max()))
            for chains in GLM_CHAINS:
                w = w_all[:chains].contiguous()
                glm_potential_grad_cuda.launches = 0
                glm_potential_grad_cuda.chain_evals = 0
                kv, kg = glm_potential_grad_cuda(x, y, w, off, scale, family)
                check((glm_potential_grad_cuda.launches,
                       glm_potential_grad_cuda.chain_evals) == (1, chains),
                      f"a {chains}-chain GLM call made "
                      f"{glm_potential_grad_cuda.launches} launches and "
                      f"{glm_potential_grad_cuda.chain_evals} chain "
                      "evaluations")
                check(all(torch.equal(kv[c], singles[c][0])
                          and torch.equal(kg[c], singles[c][1])
                          for c in range(chains)),
                      f"a {chains}-chain GLM call is not bit-identical to "
                      f"1-chain calls at n={n} d={d} {family}")
                kv2, kg2 = glm_potential_grad_cuda(x, y, w, off, scale,
                                                   family)
                check(torch.equal(kv, kv2) and torch.equal(kg, kg2),
                      "GLM kernel is not bit-identical across repeated "
                      "calls")
                if (n, d, family) == (N, D, "bernoulli_logit"):
                    nbytes = 4 * (n * d + 2 * n + 2 * chains * d + chains)
                    timing[chains] = (timings(
                        lambda: glm_potential_grad_cuda(x, y, w, off, scale,
                                                        family),
                        lambda: glm_potential_grad_ref(x, y, w, off, scale,
                                                       family), 20),
                        bound(nbytes, n * (4 * d + 12) * chains,
                              torch.float32), max(err_v, err_g))
            results.append({"n": n, "d": d, "family": family,
                            "chains": list(GLM_CHAINS),
                            "max_abs_err": max(err_v, err_g),
                            "nll_err": err_v, "grad_err": err_g,
                            "worst_err_over_tol": worst,
                            "tol": "5e-3 + 1e-5 * sum|terms| (float32 "
                                   "summation order)",
                            "bit_identical_to_single_chain": True})
    glm_potential_grad_cuda.launches = 0
    glm_potential_grad_cuda.chain_evals = 0
    return results, timing


def _enum_inputs(batch, ki, k, dtype, seed, dev, masked=False):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(batch + (ki,), generator=gen, dtype=dtype)
    m = torch.randn(batch + (ki, k), generator=gen, dtype=dtype)
    if masked:  # a -inf row and a -inf column (tests/test_kernels.py:284)
        a[1] = -math.inf
        m[:, 2] = -math.inf
    g = torch.randn(batch + (k,), generator=gen, dtype=dtype)
    return a.to(dev), m.to(dev), g.to(dev)


def enum_checks(dev):
    """The forward kernel bit-identical to its plain version, the backward
    within 1e-6 relative, on every shape in float32 and float64; timings
    at the main shape and the large one."""
    from repro_torch.kernels.enum_contract import (enum_contract_bwd_cuda,
                                                   enum_contract_bwd_ref,
                                                   enum_contract_cuda,
                                                   enum_contract_ref)
    cases = [(shape, False) for shape in ENUM_SHAPES] + [(((), 3, 4), True)]
    results, timing = [], {}
    for dtype in (torch.float32, torch.float64):
        for seed, ((batch, ki, k), masked) in enumerate(cases):
            a, m, g = _enum_inputs(batch, ki, k, dtype, seed, dev, masked)
            out = enum_contract_cuda(a, m)
            want = enum_contract_ref(a, m)
            da, dm = enum_contract_bwd_cuda(a, m, out, g)
            ra, rm = enum_contract_bwd_ref(a, m, out, g)
            torch.cuda.synchronize()
            identical = torch.equal(out, want)
            finite = torch.isfinite(want)
            fwd_err = 0.0 if identical else float(
                torch.where(finite, (out - want).abs(),
                            (out != want).to(dtype) * math.inf).max())
            bwd_err = max(float(((x - y).abs() / (1.0 + y.abs())).max())
                          for x, y in ((da, ra), (dm, rm)))
            bwd_abs = max(float((x - y).abs().max())
                          for x, y in ((da, ra), (dm, rm)))
            nan = bool(torch.isnan(da).any() or torch.isnan(dm).any())
            results.append({"batch": batch, "Ki": ki, "K": k,
                            "masked": masked, "dtype": str(dtype),
                            "fwd_bit_identical": identical,
                            "max_abs_err": fwd_err,
                            "bwd_max_rel_err": bwd_err,
                            "bwd_max_abs_err": bwd_abs, "bwd_nan": nan})
            check(identical, f"enum_contract kernel is not bit-identical to "
                             f"its plain version at {batch} x ({ki}, {k}) "
                             f"{dtype}: max error {fwd_err}")
            check(bwd_err <= ENUM_BWD_RTOL and not nan,
                  f"enum_contract_bwd disagrees at {batch} x ({ki}, {k}) "
                  f"{dtype}: {bwd_err} > {ENUM_BWD_RTOL} or NaN ({nan})")
            if masked:
                check(bool(torch.isneginf(out[2])) and float(da[1]) == 0.0
                      and float(dm[1].abs().max()) == 0.0
                      and float(dm[:, 2].abs().max()) == 0.0,
                      "enum_contract: the masked row/column is not -inf with "
                      "zero gradients")
            if dtype == torch.float32 and not masked \
                    and (batch, ki, k) in (ENUM_MAIN, ENUM_LARGE):
                timing[(batch, ki, k)] = enum_timing(a, m, g, out)
    return results, timing


def enum_timing(a, m, g, out):
    from repro_torch.kernels.enum_contract import (enum_contract_bwd_cuda,
                                                   enum_contract_bwd_ref,
                                                   enum_contract_cuda,
                                                   enum_contract_ref)
    rows, ki, k = max(1, math.prod(a.shape[:-1])), a.shape[-1], m.shape[-1]
    iters = 200 if rows == 1 else 20
    fwd = timings(lambda: enum_contract_cuda(a, m),
                  lambda: enum_contract_ref(a, m), iters)
    fwd["library_ms"] = device_ms(
        lambda: torch.logsumexp(a[..., :, None] + m, dim=-2), iters)
    bwd = timings(lambda: enum_contract_bwd_cuda(a, m, out, g),
                  lambda: enum_contract_bwd_ref(a, m, out, g), iters)
    bwd["library_ms"] = None  # no single PyTorch call computes it
    cells = rows * ki * k
    fwd_bound = bound(4 * (rows * ki + cells + rows * k),
                      5 * cells + rows * k, torch.float32)
    bwd_bound = bound(4 * (2 * rows * ki + 2 * cells + 2 * rows * k),
                      5 * cells, torch.float32)
    return {"shape": [list(a.shape), list(m.shape)],
            "enum_contract": (fwd, fwd_bound),
            "enum_contract_bwd": (bwd, bwd_bound)}


def _chain_case(T, batch, k, dtype, seed, dev, masked=False):
    """alpha0, mats and the gradient of alpha_T; ``masked``: a -inf state
    and, at two steps, a -inf column (the last gives a -inf alpha_T entry);
    a (3,) batch broadcasts a (K,) alpha0."""
    # the large shape's 8 GB of matrices are drawn on the card
    on = dev if (T - 1) * math.prod(batch) * k * k > 1e8 else "cpu"
    gen = torch.Generator(device=on).manual_seed(seed)
    a = torch.randn((k,) if batch == (3,) else batch + (k,), generator=gen,
                    dtype=dtype, device=on)
    m = torch.randn((T - 1,) + batch + (k, k), generator=gen, dtype=dtype,
                    device=on)
    if masked:
        a[1] = -math.inf
        m[2][:, 3] = -math.inf
        m[-1][:, 2] = -math.inf
    g = torch.randn(batch + (k,), generator=gen, dtype=dtype, device=on)
    return a.to(dev), m.to(dev), g.to(dev)


def _step_loops(alpha0, mats, g):
    """The chain as T-1 launches of each one-step kernel: (alphas, d_alpha0,
    d_mats)."""
    from repro_torch.kernels.enum_contract import (enum_contract_bwd_cuda,
                                                   enum_contract_cuda)
    alphas = [alpha0.broadcast_to(mats.shape[1:-1]).contiguous()]
    for mat in mats.unbind(0):
        alphas.append(enum_contract_cuda(alphas[-1], mat))
    d_mats = []
    for t in range(mats.shape[0] - 1, -1, -1):
        g, d_mat = enum_contract_bwd_cuda(alphas[t], mats[t], alphas[t + 1],
                                          g)
        d_mats.append(d_mat)
    return (torch.stack(alphas), g,
            torch.stack(d_mats[::-1]) if d_mats else torch.zeros_like(mats))


def chain_checks(dev):
    """The chain forward bit-identical to the plain chain and to T-1
    one-step launches; the chain backward bit-identical to T-1 one-step
    backward launches and within (T-1) x 1e-6 of each output's largest
    entry of the plain chain backward; one launch each (none at T = 1);
    in float32 and float64.  Timings at the main path's chain and the
    large shape."""
    from repro_torch.kernels.enum_contract import (enum_chain_bwd_cuda,
                                                   enum_chain_bwd_ref,
                                                   enum_chain_cuda,
                                                   enum_chain_ref)
    cases = [(shape, False) for shape in CHAIN_SHAPES] \
        + [((6, (), 4), True), (CHAIN_LARGE, False)]
    results, timing = [], {}
    for dtype in (torch.float32, torch.float64):
        for seed, ((T, batch, k), masked) in enumerate(cases):
            large = (T, batch, k) == CHAIN_LARGE
            if large and dtype == torch.float64:
                continue
            a, m, g = _chain_case(T, batch, k, dtype, seed, dev, masked)
            before = (enum_chain_cuda.launches, enum_chain_bwd_cuda.launches)
            alphas = enum_chain_cuda(a, m)
            d_a, d_m = enum_chain_bwd_cuda(m, alphas, g)
            launched = (enum_chain_cuda.launches - before[0],
                        enum_chain_bwd_cuda.launches - before[1])
            want = enum_chain_ref(a, m)
            r_a, r_m = enum_chain_bwd_ref(m, want, g)
            step_ok = None
            if not large:  # T-1 one-step launches of each kernel
                s_alphas, s_a, s_m = _step_loops(a, m, g)
                step_ok = bool(torch.equal(alphas, s_alphas)
                               and torch.equal(d_a, s_a)
                               and torch.equal(d_m, s_m))
            torch.cuda.synchronize()
            identical = bool(torch.equal(alphas, want))
            finite = torch.isfinite(want)
            fwd_err = 0.0 if identical else float(
                torch.where(finite, (alphas - want).abs(),
                            (alphas != want).to(dtype) * math.inf).max())
            tol = max(T - 1, 1) * ENUM_BWD_RTOL
            rel = [float((x - y).abs().max() / y.abs().max().clamp_min(
                       torch.finfo(dtype).tiny)) if y.numel() else 0.0
                   for x, y in ((d_a, r_a), (d_m, r_m))]
            abs_err = max(float((x - y).abs().max()) if y.numel() else 0.0
                          for x, y in ((d_a, r_a), (d_m, r_m)))
            nan = bool(torch.isnan(d_a).any() or torch.isnan(d_m).any())
            results.append({"T": T, "batch": batch, "K": k,
                            "masked": masked, "dtype": str(dtype),
                            "fwd_bit_identical": identical,
                            "max_abs_err": fwd_err,
                            "matches_one_step_launches": step_ok,
                            "bwd_max_abs_err": abs_err,
                            "bwd_rel_err": rel, "bwd_tol": tol,
                            "bwd_nan": nan, "launches": launched})
            where = f"T={T} {batch} K={k} {dtype}"
            check(identical, f"enum_chain is not bit-identical to the plain "
                             f"chain at {where}: max error {fwd_err}")
            check(step_ok is not False,
                  f"enum_chain/enum_chain_bwd are not bit-identical to T-1 "
                  f"one-step launches at {where}")
            check(max(rel) <= tol and not nan,
                  f"enum_chain_bwd disagrees with the plain chain at {where}:"
                  f" {rel} > {tol} or NaN ({nan})")
            check(launched == ((1, 1) if T > 1 else (0, 0)),
                  f"the chain at {where} launched {launched}")
            if masked:
                check(bool(torch.isneginf(alphas[-1][2]))
                      and float(d_a[1]) == 0.0
                      and float(d_m[2][:, 3].abs().max()) == 0.0
                      and float(d_m[-1][:, 2].abs().max()) == 0.0,
                      "enum_chain: the masked state/columns are not -inf "
                      "with zero gradients")
            del d_a, d_m, want, r_a, r_m
            if dtype == torch.float32 and (T, batch, k) in (CHAIN_MAIN,
                                                            CHAIN_LARGE):
                timing[(T, batch, k)] = chain_timing(a, m, g, alphas)
            del a, m, g, alphas
            if large:
                torch.cuda.empty_cache()
    return results, timing


def chain_timing(a, m, g, alphas):
    """Device and call ms of the chain kernels and the plain chain, their
    bounds (each input read once, each output written once), ns per step;
    at one row also the device ms of the T-1 one-step launches the chain
    replaces."""
    from repro_torch.kernels.enum_contract import (enum_chain_bwd_cuda,
                                                   enum_chain_bwd_ref,
                                                   enum_chain_cuda,
                                                   enum_chain_ref)
    steps, k = m.shape[0], m.shape[-1]
    rows = max(1, math.prod(m.shape[1:-2]))
    iters = 20 if rows == 1 else 2
    fwd = timings(lambda: enum_chain_cuda(a, m),
                  lambda: enum_chain_ref(a, m), iters)
    bwd = timings(lambda: enum_chain_bwd_cuda(m, alphas, g),
                  lambda: enum_chain_bwd_ref(m, alphas, g), iters)
    if rows == 1:
        from repro_torch.kernels.enum_contract import (
            enum_contract_bwd_cuda, enum_contract_cuda)

        def step_fwd():
            alpha = a
            for mat in m.unbind(0):
                alpha = enum_contract_cuda(alpha, mat)

        def step_bwd():
            grad = g
            for t in range(steps - 1, -1, -1):
                grad = enum_contract_bwd_cuda(alphas[t], m[t], alphas[t + 1],
                                              grad)[0]

        fwd["one_step_launches_ms"] = device_ms(step_fwd, iters)
        bwd["one_step_launches_ms"] = device_ms(step_bwd, iters)
    for t in (fwd, bwd):
        t["library_ms"] = None  # no single PyTorch call computes the chain
        t["ns_per_step"] = 1e6 * t["ms"] / steps
    cells, vec = steps * rows * k * k, rows * k
    fwd_bound = bound(4 * (cells + vec + (steps + 1) * vec),
                      steps * (5 * rows * k * k + vec), torch.float32)
    bwd_bound = bound(4 * (2 * cells + (steps + 1) * vec + 2 * vec),
                      5 * cells, torch.float32)
    return {"shape": [list(a.shape), list(m.shape)],
            "enum_chain": (fwd, fwd_bound),
            "enum_chain_bwd": (bwd, bwd_bound)}


# enum_chain_sample checks (T, K, rows): T = 1, 2, the enumerated HMM's
# 120 and the paper HMM's 600; K = 2, 3, its 8, one past a warp (33) and
# ENUM_LARGE's 64 (lanes striding over K); one row and 16; float32 and
# float64; then planted ties (integer-valued alphas, columns and noise)
SAMPLE_T, SAMPLE_K, SAMPLE_ROWS = (1, 2, ENUM_T, 600), (2, 3, ENUM_K, 33,
                                                       64), (1, 16)
SAMPLE_MAIN = (ENUM_T, 1, ENUM_K)


def _sample_case(T, rows, k, dtype, seed, dev, ties=False):
    """alphas (T, [rows,] K), mats (T-1, [rows,] K, K) and standard Gumbel
    noise, drawn on the CPU from ``seed``; ``ties``: every value an integer
    in [-2, 2), so most argmaxes are ties."""
    gen = torch.Generator().manual_seed(seed)
    batch = () if rows == 1 else (rows,)
    a = torch.randn((T,) + batch + (k,), generator=gen, dtype=dtype)
    m = torch.randn((T - 1,) + batch + (k, k), generator=gen, dtype=dtype)
    u = torch.rand((T,) + batch + (k,), generator=gen, dtype=dtype)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))
    if ties:
        a, m, g = (torch.floor(2.0 * t).clamp(-2, 1) for t in (a, m, g))
    return a.to(dev), m.to(dev), g.to(dev)


def chain_sample_checks(dev):
    """The backward sample's kernel bit-identical to its plain version on
    the card (the same inputs, the draws index for index) over SAMPLE_T x
    SAMPLE_K x SAMPLE_ROWS x float32/float64, and with planted ties; one
    launch a call.  Timing at the main path's chain (T = 120, K = 8) and at
    T = 600."""
    from repro_torch.kernels.enum_contract import (enum_chain_sample_cuda,
                                                   enum_chain_sample_ref)
    cases = [(T, rows, k, dtype, False)
             for dtype in (torch.float32, torch.float64)
             for T in SAMPLE_T for k in SAMPLE_K for rows in SAMPLE_ROWS]
    cases += [(T, rows, k, torch.float32, True)
              for T in (2, ENUM_T) for k in SAMPLE_K for rows in SAMPLE_ROWS]
    results, timing = [], {}
    for seed, (T, rows, k, dtype, ties) in enumerate(cases):
        a, m, g = _sample_case(T, rows, k, dtype, seed, dev, ties)
        before = enum_chain_sample_cuda.launches
        got = enum_chain_sample_cuda(a, m, g)
        launched = enum_chain_sample_cuda.launches - before
        want = enum_chain_sample_ref(a, m, g)
        same = bool(torch.equal(got, want))
        results.append({"T": T, "rows": rows, "K": k, "dtype": str(dtype),
                        "ties": ties, "bit_identical": same,
                        "mismatches": int((got != want).sum()),
                        "launches": launched})
        where = f"T={T} rows={rows} K={k} {dtype} ties={ties}"
        check(same, f"enum_chain_sample differs from its plain version at "
                    f"{where}: {int((got != want).sum())} draws")
        check(launched == 1, f"enum_chain_sample at {where} launched "
                             f"{launched}")
        check(tuple(got.shape) == tuple(a.shape[:-1])
              and got.dtype == torch.int64
              and bool(((got >= 0) & (got < k)).all()),
              f"enum_chain_sample at {where}: draws out of range or shape")
        if dtype == torch.float32 and not ties and rows == 1 \
                and k == ENUM_K and T in (ENUM_T, 600):
            timing[T] = chain_sample_timing(a, m, g)
    return results, timing


def chain_sample_timing(a, m, g):
    """Device and call ms of the backward sample's kernel and its plain
    version, ns a step, and the bound: the alphas and noise read once, one
    column of each step's matrix (what the draws need) and the int64
    draws written once."""
    from repro_torch.kernels.enum_contract import (enum_chain_sample_cuda,
                                                   enum_chain_sample_ref)
    T, k = a.shape[0], a.shape[-1]
    rows = max(1, math.prod(a.shape[1:-1]))
    # the plain version is ~5 eager launches a step: fewer calls of it, and
    # fewer at T = 600
    iters = 20 if T <= 120 else 3

    def kernel():
        return enum_chain_sample_cuda(a, m, g)

    def plain():
        return enum_chain_sample_ref(a, m, g)

    t = {"ms": device_ms(kernel, iters), "plain_ms": device_ms(plain, iters),
         "call_ms": call_ms(kernel, 10 * iters),
         "plain_call_ms": call_ms(plain, iters)}
    t["library_ms"] = None  # no single PyTorch call computes the scan
    t["ns_per_step"] = 1e6 * t["ms"] / T
    size = a.element_size()
    nbytes = size * rows * k * (2 * T + (T - 1)) + 8 * rows * T
    return {"shape": [list(a.shape), list(m.shape)], "times": t,
            "bound": bound(nbytes, 3 * rows * k * T, a.dtype)}


def ensemble_kernel_checks(dev):
    """The batch leapfrog (kick 0.5 and 1.0) and the MALA proposal (with
    and without grad) against their plain versions on every shape of
    ``ENS_SHAPES`` in float32 and float64, within OP_TABLE's 1e-6 (both
    kernels round every operation as the plain version does, so the error
    is expected to be 0); timings at the main shapes and the large one;
    then the accept step after the proposal (``mala_accept_checks``) and
    ChEES's opening and close (``chees_checks``)."""
    from repro_torch.kernels.leapfrog import (leapfrog_halfstep_batch_cuda,
                                              leapfrog_halfstep_batch_ref)
    from repro_torch.kernels.ops import SPECS
    from repro_torch.kernels.rwm_mala import mala_step_cuda, mala_step_ref
    results, timing = [], {}
    eps = 0.0123
    for dtype in (torch.float32, torch.float64):
        for seed, (c, d) in enumerate(ENS_SHAPES):
            gen = torch.Generator().manual_seed(seed)
            z, r, g, noise = (torch.randn((c, d), generator=gen,
                                          dtype=dtype).to(dev)
                              for _ in range(4))
            m_inv = (torch.rand(d, generator=gen, dtype=dtype) + 0.5).to(dev)
            # the step size as the graphed trajectory holds it, on the card
            eps_dev = torch.full((1,), eps, dtype=dtype, device=dev)
            cases = [("leapfrog_halfstep_batch", f"kick={kick}",
                      lambda k=kick: leapfrog_halfstep_batch_cuda(
                          z, r, g, m_inv, eps_dev, k),
                      lambda k=kick: leapfrog_halfstep_batch_ref(
                          z, r, g, m_inv, eps_dev, k))
                     for kick in (0.5, 1.0)]
            cases += [("mala_step", variant,
                       lambda gr=grad: (mala_step_cuda(z, gr, noise, m_inv,
                                                       eps),),
                       lambda gr=grad: (mala_step_ref(z, gr, noise, m_inv,
                                                      eps),))
                      for variant, grad in (("MALA", g), ("RWM", None))]
            for name, variant, kernel, plain in cases:
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in
                          zip(got, want))
                identical = all(torch.equal(a, b) for a, b in zip(got, want))
                tol = SPECS[name].tol
                results.append({"name": name, "variant": variant,
                                "shape": [c, d], "dtype": str(dtype),
                                "max_abs_err": err, "tol": tol,
                                "bit_identical": identical})
                check(err <= tol, f"{name} ({variant}) disagrees at "
                                  f"{(c, d)} {dtype}: {err} > {tol}")
                main = {"leapfrog_halfstep_batch": ENS_CHEES,
                        "mala_step": ENS_MRW}[name]
                if dtype == torch.float32 and (c, d) in (main, ENS_LARGE) \
                        and variant != "kick=0.5":
                    iters = 200 if (c, d) == main else 10
                    timing[(name, variant, (c, d))] = (
                        timings(kernel, plain, iters),
                        ensemble_bound(name, variant, c, d), err)
    accept, accept_timing = mala_accept_checks(dev)
    results += accept
    for (variant, phase), entry in accept_timing.items():
        timing[("mala_accept", f"{variant}, {phase}", ENS_MRW)] = entry
    chees, chees_timing = chees_checks(dev)
    return results + chees, {**timing, **chees_timing}


# chees_accept's modes: (name, n_post, the gradient, the Welford fold)
CHEES_MODES = (("sampling", 7, False, False), ("warmup", 0, False, False),
               ("warmup, gradient", 0, True, False),
               ("warmup, gradient, fold", 0, True, True))
CHEES_H = 0.37  # the jitter factor h of the ChEES gradient's checks
CHEES_EPS = 0.0123


def chees_operands(c, d, dtype, seed, dev, eps):
    """A ChEES transition's close as the sampler makes it: the state (z0,
    pe0, g0), the standard-normal draw n, the trajectory's end (z1, r, g1)
    after a plain opening and one interior step, and potentials pe1 that
    put delta = energy_new - energy_cur near N(0, 0.5^2), so accept_prob
    spreads over (0, 1]; chain 0's pe1 inf and chain 1's NaN where C >= 3.
    Returns chees_accept's first ten arguments (eps a device scalar), the
    uniforms u, a running mean and a Welford accumulator (mean, m2)."""
    from repro_torch.kernels.leapfrog import (chees_open_ref,
                                              leapfrog_halfstep_batch_ref)
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=dtype)

    z0, g0, n = rand(c, d), rand(c, d), rand(c, d)
    m = torch.rand(d, generator=gen, dtype=dtype) + 0.5
    z1, r = chees_open_ref(z0, n, g0, m, eps)
    g1 = g0 + 0.2 * rand(c, d)
    z1, r = leapfrog_halfstep_batch_ref(z1, r, g1, m, eps, 1.0)
    pe0 = 3.0 * rand(c).abs()
    r0, r1 = n / torch.sqrt(m), r - 0.5 * eps * g1

    def ke(v):
        v = v.double()
        return 0.5 * (v * (m.double() * v)).sum(-1)

    pe1 = (pe0.double() + ke(r0) - ke(r1) + 0.5 * rand(c).double()) \
        .to(dtype)
    if c >= 3:
        pe1[0], pe1[1] = float("inf"), float("nan")
    u, mean = (torch.rand(c, generator=gen, dtype=dtype) for _ in range(2))
    wf = (rand(d), rand(d).abs())
    eps_dev = torch.full((1,), eps, dtype=dtype)
    moved = [t.to(dev) for t in (z0, pe0, g0, n, m, z1, r, pe1, g1, eps_dev,
                                 u, mean, *wf)]
    return tuple(moved[:10]), moved[10], moved[11], tuple(moved[12:])


def chees_plain_sums(args, ap, div):
    """The five sums over D of chees_accept (ke0, ke1, |z1c|^2, |z0c|^2,
    z1c . v1) as the plain version forms them on the card (``torch.sum`` in
    the dtype; the centred ones from the kernel's accept_prob and
    divergences, as ``chees_gradient`` does), and the sums of their terms'
    magnitudes in float64, the scale of FUSED_REL_TOL."""
    from repro_torch.kernels.leapfrog import chain_sum
    z0, pe0, g0, n, m, z1, r, pe1, g1, eps = args
    r0, r1 = n / torch.sqrt(m), r - 0.5 * eps * g1
    weights = torch.where(div, 0.0, ap)
    keep = (weights > 0)[:, None]
    z1k, v1 = torch.where(keep, z1, 0.0), torch.where(keep, m * r1, 0.0)
    w_sum = torch.clamp(chain_sum(weights), min=1e-10)
    w = weights[:, None]
    z0c = z0 - chain_sum(w * z0) / w_sum
    z1c = torch.where(keep, z1k - chain_sum(w * z1k) / w_sum, 0.0)
    terms = [r0 * (m * r0), r1 * (m * r1), z1c * z1c, z0c * z0c, z1c * v1]
    half = [0.5, 0.5, 1.0, 1.0, 1.0]
    plain = torch.stack([k * t.sum(-1) for k, t in zip(half, terms)], 1)
    scale = torch.stack([k * t.double().abs().sum(-1)
                         for k, t in zip(half, terms)], 1)
    return plain, scale


def chees_checks(dev, shapes=ENS_SHAPES, dtypes=(torch.float32,
                                                  torch.float64)):
    """Row 3 with its device eps against the by-value form (a host number
    the wrapper stages) and the plain version, in place and not;
    ``chees_open`` against its plain version; ``chees_accept`` in each of
    ``CHEES_MODES`` against its plain version: every shape of
    ``ENS_SHAPES``, float32 and float64, chain 0's pe1 inf and chain 1's
    NaN (C >= 3), and an all-divergent warmup.  The sums over D within
    FUSED_REL_TOL of their terms' magnitudes; from the kernel's own sums
    the plain arithmetic gives its energies, accept_prob and divergences;
    for the kernel's accept_prob the selections, the running mean, the
    harmonic mean, the gradient and the Welford fold bit-identical;
    accept_prob within what the sums' tolerance allows of the plain
    version's, the same divergences; a repeated call bit-identical.
    Timings in float32 at ChEES's (8, 54) and at (64, 1,000,003) where
    ``shapes`` holds them."""
    from repro_torch.kernels.leapfrog import (
        chain_sum, chees_accept_cuda, chees_accept_ref, chees_open_cuda,
        chees_open_ref, harmonic_mean_accept, leapfrog_halfstep_batch_cuda,
        leapfrog_halfstep_batch_ref, welford_merge, welford_moments)
    from repro_torch.core.infer.hmc_util import welford_ratios
    results, timing = [], {}
    eps = CHEES_EPS
    for dtype in dtypes:
        for seed, (c, d) in enumerate(shapes):
            args, u, mean, wf = chees_operands(c, d, dtype, seed, dev, eps)
            z0, pe0, g0, n, m, z1, r, pe1, g1, eps_dev = args
            # row 3 and chees_open: device eps == by value == plain
            row3, opening = {}, {}
            for kick in (0.5, 1.0):
                dev_eps = leapfrog_halfstep_batch_cuda(z0, r, g1, m, eps_dev,
                                                       kick)
                by_value = leapfrog_halfstep_batch_cuda(z0, r, g1, m, eps,
                                                        kick)
                plain = leapfrog_halfstep_batch_ref(z0, r, g1, m, eps, kick)
                zc, rc = z0.clone(), r.clone()
                leapfrog_halfstep_batch_cuda(zc, rc, g1, m, eps_dev, kick,
                                             out=(zc, rc))
                row3[kick] = all(
                    same_bits(a, b) and same_bits(a, p) and same_bits(a, q)
                    for a, b, p, q in zip(dev_eps, by_value, plain,
                                          (zc, rc)))
            got = chees_open_cuda(z0, n, g0, m, eps_dev)
            want = chees_open_ref(z0, n, g0, m, eps)
            zc = z0.clone()
            rc = torch.empty_like(r)
            chees_open_cuda(zc, n, g0, m, eps_dev, out=(zc, rc))
            opening = all(same_bits(a, b) and same_bits(a, q)
                          for a, b, q in zip(got, want, (zc, rc)))
            results.append({"name": "leapfrog_halfstep_batch",
                            "variant": "device eps", "shape": [c, d],
                            "dtype": str(dtype),
                            "bit_identical_to_by_value_and_plain":
                                row3[0.5] and row3[1.0], "max_abs_err": 0.0})
            results.append({"name": "chees_open", "shape": [c, d],
                            "dtype": str(dtype),
                            "bit_identical": opening, "max_abs_err": float(
                                max((a - b).abs().max()
                                    for a, b in zip(got, want)))})
            check(row3[0.5] and row3[1.0] and opening,
                  f"row 3 (device eps {row3}) or chees_open ({opening}) "
                  f"differs at {(c, d)} {dtype}")
            cases = [(name, n_post, grad, fold, pe1)
                     for name, n_post, grad, fold in CHEES_MODES]
            cases.append(("warmup, gradient, all divergent", 0, True, False,
                          torch.full_like(pe1, float("inf"))))
            for name, n_post, grad, fold, pe1_case in cases:
                a = args[:7] + (pe1_case,) + args[8:]
                h = CHEES_H if grad else None
                welford = (*wf, *welford_ratios(40, c)) if fold else None
                call = (*a, u, 1000.0, mean, n_post, h, welford)
                sums = torch.empty((c, 5), dtype=dtype, device=dev)
                got = chees_accept_cuda(*call, sums=sums)
                again = chees_accept_cuda(*call)
                want = chees_accept_ref(*call)
                torch.cuda.synchronize()
                ap, div = got[4], got[5]
                plain_sums, scale = chees_plain_sums(a, ap, div)
                cols = 5 if grad else 2
                sums_rel = float(((sums[:, :cols].double()
                                   - plain_sums[:, :cols].double()).abs()
                                  / scale[:, :cols].clamp(min=1e-300))
                                 .nan_to_num(nan=0.0).max())
                e_cur, e_new = a[1] + sums[:, 0], a[7] + sums[:, 1]
                delta = torch.where(torch.isnan(e_new), math.inf,
                                    e_new - e_cur)
                ap_s = torch.clamp(torch.exp(-delta), max=1.0)
                from_sums = same_bits(ap_s, ap) and torch.equal(
                    delta > 1000.0, div)
                acc = u < ap
                picks = [(got[0], torch.where(acc[:, None], z1, z0)),
                         (got[1], torch.where(acc, a[7], pe0)),
                         (got[2], torch.where(acc[:, None], g1, g0)),
                         (got[3], torch.where(acc, e_new, e_cur))]
                if n_post:
                    picks.append((got[6], mean + (ap - mean) / n_post))
                else:
                    weights = torch.where(div, 0.0, ap)
                    w_sum = torch.clamp(chain_sum(weights), min=1e-10)
                    stat = torch.zeros((), dtype=dtype, device=dev)
                    if grad:
                        per_chain = h * (sums[:, 2] - sums[:, 3]) \
                            * sums[:, 4]
                        stat = chain_sum(weights * per_chain) / w_sum
                        stat = torch.where(torch.isfinite(stat), stat, 0.0)
                    picks.append((got[7], torch.stack(
                        [harmonic_mean_accept(ap), stat])))
                    if fold:
                        picks += list(zip(got[8], welford_merge(
                            *wf, *welford_moments(got[0]), welford[2],
                            welford[3])))
                identical = all(same_bits(x, y) for x, y in picks)
                both_nan = ap.isnan() & want[4].isnan()
                err = torch.where(both_nan, 0.0,
                                  (ap - want[4]).abs()).double()
                tol = torch.expm1(FUSED_REL_TOL * (
                    a[1].double().abs() + a[7].double().abs().nan_to_num(
                        nan=0.0, posinf=0.0) + scale[:, 0] + scale[:, 1]))
                within = bool((err <= tol * torch.maximum(
                    ap, want[4]).double().nan_to_num() + 1e-300).all())
                same_div = torch.equal(div, want[5])
                repeat = all(same_bits(x, y) for x, y in zip(
                    got[:5] + (got[6],), again[:5] + (again[6],))) and \
                    torch.equal(got[5], again[5]) and (
                        n_post > 0 or same_bits(got[7], again[7]))
                spread = ap[~ap.isnan()]
                results.append({
                    "name": "chees_accept", "mode": name, "shape": [c, d],
                    "dtype": str(dtype), "sums_rel_err": sums_rel,
                    "max_abs_err": float(err.max()),
                    "accept_prob_within_tolerance": within,
                    "accept_prob_range": [float(spread.min()),
                                          float(spread.max())]
                    if spread.numel() else None,
                    "selections_bit_identical": identical,
                    "scalars_from_sums_bit_identical": from_sums,
                    "same_divergences_as_plain": same_div,
                    "repeat_bit_identical": repeat})
                check(sums_rel <= FUSED_REL_TOL and identical and within
                      and same_div and repeat,
                      f"chees_accept ({name}) disagrees at {(c, d)} "
                      f"{dtype}: sums {sums_rel} of their terms, selections "
                      f"{identical}, accept_prob within {within}, the same "
                      f"divergences {same_div}, repeat {repeat}")
            if dtype == torch.float32 and (c, d) in (ENS_CHEES, ENS_LARGE):
                iters = 200 if (c, d) == ENS_CHEES else 10
                timing[("chees_open", "", (c, d))] = (
                    timings(lambda: chees_open_cuda(z0, n, g0, m, eps_dev),
                            lambda: chees_open_ref(z0, n, g0, m, eps_dev),
                            iters),
                    bound(4 * (5 * c * d + d + 1), 7 * c * d,
                          torch.float32), 0.0)
                for name, n_post, grad, fold in CHEES_MODES[::3]:
                    h = CHEES_H if grad else None
                    welford = (*wf, *welford_ratios(40, c)) if fold else None
                    call = (*args, u, 1000.0, mean, n_post, h, welford)
                    err = max(r_["max_abs_err"] for r_ in results
                              if r_["name"] == "chees_accept"
                              and r_["mode"] == name
                              and r_["shape"] == [c, d]
                              and r_["dtype"] == str(dtype))
                    timing[("chees_accept", name, (c, d))] = (
                        timings(lambda a=call: chees_accept_cuda(*a),
                                lambda a=call: chees_accept_ref(*a), iters),
                        chees_accept_bound(c, d, grad, fold), err)
    return results, timing


def chees_accept_bound(c, d, grad, fold):
    """Bytes of one float32 call: n, r, g1, z0, z1 and g0 read and z, g
    written, each (C, D) once, plus m_inv, eps, pe0, pe1, u and the mean in,
    pe, energy, accept_prob, diverging (a byte) and the mean or the two
    statistics out, and with the fold the accumulator's (mean, m2) in and
    out.  Operations an element: 9 for the two kinetic energies' terms and
    sums, 14 for the gradient's column means and centred sums, 4 for the
    fold."""
    cells = c * d
    moved = 8 * cells + d + 1 + 5 * c + (4 * d if fold else 0)
    flops = (9 + (14 if grad else 0) + (4 if fold else 0)) * cells
    return bound(4 * moved + c, flops, torch.float32)


def trajectory_checks(dev, data, chains=CHEES_CHAINS):
    """The graphed trajectory (``graphs.EnsembleTrajectory``) against the
    same functions run eagerly, on ChEES's potential (the fused GLM logreg
    on the 581,012 x 54 data) at (8, 54): 1 step (the opening's eager run,
    then its capture), 5 steps (the opening replayed; the interior's eager
    run, capture and three replays) and 5 steps again (replays only).  z,
    r, pe and the gradient bit-identical each time, and the launch counters
    moved by what the eager run launched."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import ChEES
    from repro_torch.core.infer.graphs import EnsembleTrajectory
    from repro_torch.core.infer.hmc_util import chain_value_and_grad
    from repro_torch.kernels import ops
    x, y = (torch.from_numpy(data[k]).to(dev) for k in ("x", "y"))
    pot = ChEES(logreg_model_glm).setup(
        torch.Generator().manual_seed(0), 10, model_args=(x,),
        model_kwargs={"y": y}).potential_fn
    check(pot.glm_prior_batch == "vmap", "ChEES's potential does not batch "
          "its prior under torch.func.vmap")
    graphed, eager = EnsembleTrajectory(pot, True), EnsembleTrajectory(pot,
                                                                       False)
    gen = torch.Generator().manual_seed(11)
    c, d = chains, data["x"].shape[1]
    z = (0.1 * torch.randn(c, d, generator=gen)).to(dev)
    _, g = chain_value_and_grad(pot)(z)
    m = (torch.rand(d, generator=gen) + 0.5).to(dev)
    results = []
    keys = ("chees_open", "leapfrog_halfstep_batch", "glm_potential_grad")
    for steps in (1, 5, 5):
        n, u = torch.randn(c, d, generator=gen), torch.rand(c, generator=gen)
        ops.reset_launch_counts()
        n_g, _, eps_g = graphed.stage(n, u, 0.01, dev)
        got = graphed(z, g, n_g, m, eps_g, steps)
        torch.cuda.synchronize()
        counts_g = ops.launch_counts()
        ops.reset_launch_counts()
        want = eager(z, g, n.to(dev), m, eps_g.clone(), steps)
        torch.cuda.synchronize()
        counts_e = ops.launch_counts()
        identical = all(same_bits(a, b) for a, b in zip(got, want))
        counted = all(counts_g[k] == counts_e[k] for k in keys) and \
            counts_e["chees_open"] == 1 and \
            counts_e["leapfrog_halfstep_batch"] == steps - 1 and \
            counts_e["glm_potential_grad"] == steps
        results.append({"steps": steps, "bit_identical": identical,
                        "launches_graphed": {k: counts_g[k] for k in keys},
                        "launches_eager": {k: counts_e[k] for k in keys},
                        **graphed.stats()})
        check(identical and counted, f"the graphed trajectory ({steps} "
              f"steps) differs from the eager one: bit-identical "
              f"{identical}, launches {counts_g} vs {counts_e}")
    return results


def ensemble_bound(name, variant, c, d):
    """Bytes (each (C, D) input read once, each output written once, plus
    the m_inv row) and operations of one call, float32."""
    cells = c * d
    if name == "leapfrog_halfstep_batch":   # z, r, g in; z', r' out
        return bound(4 * (5 * cells + d), 5 * cells, torch.float32)
    if variant == "MALA":                   # z, g, noise in; z' out
        return bound(4 * (4 * cells + d), 4 * cells + 3 * d, torch.float32)
    return bound(4 * (3 * cells + d), 2 * cells + 2 * d, torch.float32)


def profile_transitions(mcmc, num, kernels=None, host_ops=True):
    """Device busy share and device time per leapfrog over ``num`` more
    sampling transitions of the adapted chain (or ensemble: there a
    "leapfrog" moves every chain, and a MALA/RWM proposal counts as one),
    under ``torch.profiler``.  The profiler adds host cost, so its wall
    time is not the run's.  ``kernels`` (op name -> a substring of its
    device kernel's name) adds, per op, the profiler's count of that
    kernel and the op's launch counter's increase over the same
    transitions.  ``host_ops=False`` records the device activity alone
    (the host ops' events of a long window take minutes to aggregate)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.infer import GeneratorDraws, sample
    from repro_torch.kernels import ops

    setup = mcmc.kernel_setup
    # a lockstep run's last state is one batched state: a "leapfrog" is
    # then a lockstep leaf, moving every chain still growing its tree
    batch = not isinstance(mcmc.last_state, list)
    if batch:
        state = mcmc.last_state
        draws = [GeneratorDraws(torch.Generator().manual_seed(7 + c))
                 for c in range(state.z.shape[0])]
        step, lockstep = setup.sample_batch_fn, setup.sample_batch_fn.lockstep
    else:
        state = mcmc.last_state[0]
        draws = GeneratorDraws(torch.Generator().manual_seed(7))

        def step(s, d):
            return sample(setup, s, d)
    state = step(state, draws)
    torch.cuda.synchronize()
    leapfrogs = 0
    leaves0 = lockstep.leapfrogs if batch else 0
    counts0 = ops.launch_counts()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(num):
            state = step(state, draws)
            if not batch:
                leapfrogs += getattr(state, "num_steps", 1)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    if batch:
        leapfrogs = lockstep.leapfrogs - leaves0
    counts = ops.launch_counts()
    rows = [(getattr(a, "self_device_time_total", 0.0), a.count, a.key)
            for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        return {"device_busy_share": None,
                "note": "the profiler recorded no device time"}
    top = sorted(rows, reverse=True)[:8]
    out = {
        "transitions": num, "leapfrogs": leapfrogs,
        "wall_ms_per_leapfrog_profiled": wall_us / 1e3 / leapfrogs,
        "device_busy_ms_per_leapfrog": busy_us / 1e3 / leapfrogs,
        "device_busy_share": busy_us / wall_us,
        "device_kernels_per_leapfrog": sum(r[1] for r in rows) / leapfrogs,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_leapfrog": t / 1e3 / leapfrogs,
             "launches_per_leapfrog": c / leapfrogs} for t, c, k in top]}
    if kernels:
        out["kernel_counts"] = {
            name: {"profiler": sum(c for _, c, k in rows if sub in k),
                   "counter": counts[name] - counts0[name]}
            for name, sub in kernels.items()}
    return out


def run_main_path(dev, data, data_s):
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    out = {}
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(logreg_model_glm), num_warmup=100, num_samples=100)
    mcmc.run(0, data["x"], y=data["y"])
    counts = ops.launch_counts()
    samples = mcmc.get_samples(group_by_chain=True)["w"]
    extra = mcmc.get_extra_fields()
    stats = mcmc.stats
    w = samples.detach().cpu().numpy()
    check(w.shape == (1, 100, D) and np.all(np.isfinite(w)),
          f"samples have shape {w.shape} or are not finite")
    post_err = float(np.max(np.abs(w.mean((0, 1)) - data["true_w"])))
    divergences = int(extra["diverging"].sum())
    out["adaptive"] = {
        "num_warmup": 100, "num_samples": 100, "data_seconds": data_s,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"],
        "num_leapfrog": stats["num_leapfrog"],
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / stats["num_leapfrog"],
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_leapfrog": stats["host_syncs"] / stats["num_leapfrog"],
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "mean_num_steps": float(extra["num_steps"].float().mean()),
        "step_size": float(extra["step_size"][-1]),
        "divergences": divergences,
        "max_abs_posterior_mean_minus_true_w": post_err,
        "min_ess": float(np.min(effective_sample_size(w))),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "glm_prior": stats["glm_prior"],
    }
    print("adaptive NUTS:", json.dumps(out["adaptive"]), flush=True)
    mcmc.print_summary()
    check(divergences == 0, f"{divergences} divergent transitions")
    check(post_err < 0.05, f"posterior mean is {post_err} from true_w")
    check(stats["glm_prior"] == "slim", f"the fused potential's prior term "
          f"runs on the {stats['glm_prior']} data, not on 0 rows")
    check(counts["glm_potential_grad"] >= stats["num_leapfrog"],
          f"glm_potential_grad: {counts['glm_potential_grad']} launches < "
          f"{stats['num_leapfrog']} leapfrogs: the main path did not run "
          "through its kernel")
    tree_gates(counts, stats)

    out["profile"] = profile_transitions(mcmc, 20)
    print("profile:", json.dumps(out["profile"]), flush=True)

    # the paper's fixed-step configuration (benchmarks/logreg.py:27-29)
    ops.reset_launch_counts()
    fixed = MCMC(NUTS(logreg_model_glm, step_size=0.0015,
                      adapt_step_size=False, adapt_mass_matrix=False),
                 num_warmup=0, num_samples=40)
    fixed.run(1, data["x"], y=data["y"])
    fstats = fixed.stats
    out["fixed_step"] = {
        "num_samples": 40, "step_size": 0.0015,
        "num_leapfrog": fstats["num_leapfrog"],
        "chain_seconds": fstats["chain_seconds"],
        "ms_per_leapfrog": 1e3 * fstats["chain_seconds"]
        / fstats["num_leapfrog"],
        "host_syncs_per_leapfrog": fstats["host_syncs"]
        / fstats["num_leapfrog"],
        "launches": ops.launch_counts(),
        "divergences": int(fixed.get_extra_fields()["diverging"].sum()),
    }
    print("fixed-step NUTS:", json.dumps(out["fixed_step"]), flush=True)
    fw = fixed.get_samples()["w"]
    check(bool(torch.isfinite(fw).all()), "fixed-step samples not finite")
    tree_gates(out["fixed_step"]["launches"], fstats)
    return out, counts


def chain_departures(setup, seed, chains, transitions):
    """For each chain of a lockstep run (``setup``'s batched transition,
    the draw sources ``MCMC.run(seed)`` gives its chains), the first
    transition at which its position differs from a lone run of that
    chain's source (0: the initial point), or None within
    ``transitions``."""
    from repro_torch.core.infer import GeneratorDraws

    seeds = np.random.SeedSequence(seed).generate_state(chains,
                                                        dtype=np.uint64)

    def sources():
        return [GeneratorDraws(torch.Generator().manual_seed(int(s)))
                for s in seeds]

    draws = sources()
    state = setup.init_batch_fn(draws)
    zs = [state.z.clone()]
    for _ in range(transitions):
        state = setup.sample_batch_fn(state, draws)
        zs.append(state.z)
    batched = torch.stack(zs, 1).cpu()
    first = []
    for c, lone in enumerate(sources()):
        one = setup.init_fn(lone)
        departed = None
        for t in range(transitions + 1):
            if t:
                one = setup.sample_fn(one, lone)
            if not torch.equal(one.z.cpu(), batched[c, t]):
                departed = t
                break
        first.append(departed)
    return first


def vectorized_profile(state_path):
    """``VEC_PROFILE_TRANSITIONS`` profiled lockstep transitions of the
    vectorized logreg (``profile_transitions``, device activity alone) from
    the adapted batched state ``run_nuts_vectorized`` saved to
    ``state_path``, through a setup built as ``MCMC.run`` builds it."""
    from types import SimpleNamespace

    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import NUTS
    data = covtype_data(seed=0, n=N, d=D)
    dev = torch.device("cuda")
    setup = NUTS(logreg_model_glm).setup(
        torch.Generator().manual_seed(0), VEC_WARMUP,
        model_args=(torch.from_numpy(data["x"]).to(dev),),
        model_kwargs={"y": torch.from_numpy(data["y"]).to(dev)})
    state = torch.load(state_path, weights_only=False)
    mcmc = SimpleNamespace(kernel_setup=setup, last_state=state)
    return profile_transitions(mcmc, VEC_PROFILE_TRANSITIONS, host_ops=False)


def run_nuts_vectorized(dev, data, single):
    """``MCMC(NUTS(logreg_model_glm), 100, 100, num_chains=8)`` with the
    default ``chain_method="vectorized"`` on the single chain's data: the
    chains in lockstep, one ``nuts_leaf_batch`` launch a lockstep leapfrog
    and one GLM launch for the live chains' gradients.  Gates: 0
    divergences, the pooled posterior mean within 0.05 of ``true_w``, split
    R-hat < 1.05, the lockstep tree's launches (no one-chain ``nuts_leaf``),
    every GLM launch accounted for.  Prints the per-chain throughput beside
    the single chain's (``single``: ``run_main_path``'s adaptive run), each
    chain's departure from a lone run of its seed, and a profile in a fresh
    process."""
    import tempfile

    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import (MCMC, NUTS, effective_sample_size,
                                        gelman_rubin)
    from repro_torch.kernels import ops
    from repro_torch.kernels.glm_potential import glm_potential_grad_cuda

    reset_peak(dev)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(logreg_model_glm), num_warmup=VEC_WARMUP,
                num_samples=VEC_DRAWS, num_chains=VEC_CHAINS)
    mcmc.run(0, data["x"], y=data["y"])
    counts = ops.launch_counts()
    chain_evals = glm_potential_grad_cuda.chain_evals
    stats = mcmc.stats
    w = mcmc.get_samples(group_by_chain=True)["w"].detach().cpu().numpy()
    extra = mcmc.get_extra_fields()
    lf, leaves = stats["num_leapfrog"], stats["lockstep_leapfrogs"]
    secs, init = stats["chain_seconds"], stats["init_grad_evals"]
    post_err = float(np.max(np.abs(w.mean((0, 1)) - data["true_w"])))
    rhat = float(np.max(gelman_rubin(w)))
    divergences = int(extra["diverging"].sum())
    per_chain_rate = lf / secs
    single_rate = single["num_leapfrog"] / single["chain_seconds"]
    out = {
        "num_chains": VEC_CHAINS, "num_warmup": VEC_WARMUP,
        "num_samples": VEC_DRAWS, "setup_seconds": stats["setup_seconds"],
        "chain_seconds": secs, "num_leapfrog": lf,
        "lockstep_leapfrogs": leaves,
        "lockstep_efficiency": stats["lockstep_efficiency"],
        "ms_per_lockstep_leapfrog": 1e3 * secs / leaves,
        "ms_per_leapfrog": 1e3 * secs / lf,
        "per_chain_leapfrogs_per_s": per_chain_rate,
        "single_chain_leapfrogs_per_s": single_rate,
        "per_chain_throughput_ratio": per_chain_rate / single_rate,
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_lockstep_leapfrog": stats["host_syncs"] / leaves,
        "num_grad_evals": stats["num_grad_evals"], "init_grad_evals": init,
        "launches": counts, "glm_chain_evals": chain_evals,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "mean_num_steps": float(extra["num_steps"].float().mean()),
        "divergences": divergences,
        "max_abs_posterior_mean_minus_true_w": post_err,
        "max_split_rhat": rhat,
        "min_ess": float(np.min(effective_sample_size(w))),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    print("vectorized NUTS:", json.dumps(out), flush=True)
    check(w.shape == (VEC_CHAINS, VEC_DRAWS, D) and np.all(np.isfinite(w)),
          f"samples have shape {w.shape} or are not finite")
    check(divergences == 0, f"{divergences} divergent transitions")
    check(post_err < 0.05, f"pooled posterior mean is {post_err} from "
                           "true_w")
    check(rhat < VEC_RHAT_MAX, f"max split R-hat {rhat} >= {VEC_RHAT_MAX}")
    lockstep_gates(counts, stats)
    check(stats["num_grad_evals"] == lf + init,
          f"{stats['num_grad_evals']} gradient evaluations != {lf} "
          f"leapfrogs + {init} search evaluations")
    check(counts["glm_potential_grad"] == leaves + init + 1,
          f"glm_potential_grad: {counts['glm_potential_grad']} launches != "
          f"{leaves} lockstep gradients + {init} search evaluations + 1 "
          "(the setup's check)")
    check(chain_evals == stats["num_grad_evals"] + 1,
          f"glm_potential_grad: {chain_evals} chain evaluations != "
          f"{stats['num_grad_evals']} + 1 (the setup's check)")
    # the host's cost of a lockstep leaf's potential (eager calls at the
    # final state): the batched entry for all chains and for half of them
    # (gathered, scattered back), beside the one-chain potential
    from repro_torch.core.infer.hmc_util import (rows_value_and_grad,
                                                 value_and_grad)
    potential = mcmc.kernel_setup.potential_fn
    rows = rows_value_and_grad(potential)
    one = value_and_grad(potential)
    z = mcmc.last_state.z
    half = np.arange(VEC_CHAINS) % 2 == 0
    out["potential_call_ms"] = {
        f"all {VEC_CHAINS} chains": call_ms(
            lambda: rows(z, np.ones(VEC_CHAINS, bool)), 50),
        f"{int(half.sum())} of {VEC_CHAINS}": call_ms(lambda: rows(z, half),
                                                      50),
        "one chain": call_ms(lambda: one(z[0]), 50)}
    print("vectorized NUTS: potential ms a call:",
          json.dumps(out["potential_call_ms"]), flush=True)
    out["departures"] = chain_departures(mcmc.kernel_setup, 0, VEC_CHAINS,
                                         VEC_DEPART_TRANSITIONS)
    print("vectorized NUTS: first transition each chain departs from a lone "
          f"run of its seed (of {VEC_DEPART_TRANSITIONS}):",
          json.dumps(out["departures"]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vectorized_state.pt")
        torch.save(mcmc.last_state, path)
        out["profile"] = in_fresh_process("vectorized_profile", path)
    print("vectorized NUTS profile (fresh process):",
          json.dumps(out["profile"]), flush=True)
    return out, counts


def _conjugate_normal(y, sigma0, sigma):
    """tests/test_ensemble.py:186's model: mu ~ N(0, sigma0), y ~ N(mu,
    sigma)."""
    import repro_torch.core as pc
    from repro_torch.core import dist
    mu = pc.sample("mu", dist.Normal(0.0, sigma0))
    with pc.plate("N", y.shape[0]):
        pc.sample("obs", dist.Normal(mu, sigma), obs=y)


def run_cross_chain(dev):
    """``NUTS(cross_chain_adapt=True)``, 4 chains, 300 + 400, on the
    reference test's conjugate normal model: its posterior mean and
    variance bounds, split R-hat < 1.05, every chain's inverse mass matrix
    the same pooled estimate after warmup, the lockstep tree's launches."""
    from repro_torch.core.infer import MCMC, NUTS, gelman_rubin
    from repro_torch.kernels import ops

    sigma0, sigma = 2.0, 1.0
    y = np.random.default_rng(0).normal(1.8, sigma, size=50).astype(
        np.float32)
    post_var = 1.0 / (1 / sigma0 ** 2 + len(y) / sigma ** 2)
    post_mean = post_var * (float(y.sum()) / sigma ** 2)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(lambda y: _conjugate_normal(y, sigma0, sigma),
                     cross_chain_adapt=True),
                num_warmup=XCHAIN_WARMUP, num_samples=XCHAIN_DRAWS,
                num_chains=XCHAIN_CHAINS)
    mcmc.run(0, y)
    counts = ops.launch_counts()
    stats = mcmc.stats
    mu = mcmc.get_samples()["mu"].double()
    grouped = mcmc.get_samples(group_by_chain=True)["mu"].cpu().numpy()
    imm = mcmc.last_state.adapt_state.inverse_mass_matrix
    shared = bool((imm == imm[0]).all())
    out = {"num_chains": XCHAIN_CHAINS, "num_warmup": XCHAIN_WARMUP,
           "num_samples": XCHAIN_DRAWS, "chain_seconds": stats["chain_seconds"],
           "num_leapfrog": stats["num_leapfrog"],
           "lockstep_leapfrogs": stats["lockstep_leapfrogs"],
           "lockstep_efficiency": stats["lockstep_efficiency"],
           "ms_per_lockstep_leapfrog": 1e3 * stats["chain_seconds"]
           / stats["lockstep_leapfrogs"],
           "mean_minus_posterior": float(mu.mean()) - post_mean,
           "var_minus_posterior": float(mu.var()) - post_var,
           "split_rhat": float(gelman_rubin(grouped)),
           "inverse_mass_matrix": imm.reshape(-1).tolist(),
           "shared_mass_matrix": shared, "launches": counts}
    print("cross-chain NUTS:", json.dumps(out), flush=True)
    check(abs(out["mean_minus_posterior"]) < 0.1,
          f"posterior mean off by {out['mean_minus_posterior']}")
    check(abs(out["var_minus_posterior"]) < 0.05,
          f"posterior variance off by {out['var_minus_posterior']}")
    check(out["split_rhat"] < 1.05, f"split R-hat {out['split_rhat']}")
    check(shared and tuple(imm.shape) == (XCHAIN_CHAINS, 1),
          f"the chains' inverse mass matrices differ after warmup: {imm}")
    lockstep_gates(counts, stats)
    return out, counts


def run_dense(dev):
    """``NUTS(dense_mass=True)`` on tests/test_mcmc.py:191's correlated
    Gaussian (rho = 0.95), one chain, 300 + 300: finite draws, |mean| <
    0.2, and no leaf kernel: the dense leaf is plain torch by design."""
    import repro_torch.core as pc
    from repro_torch.core import dist
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    cov = torch.tensor([[1.0, DENSE_RHO], [DENSE_RHO, 1.0]], device=dev)

    def model():
        pc.sample("x", dist.MultivariateNormal(torch.zeros(2, device=dev),
                                               covariance_matrix=cov))

    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(model, dense_mass=True), num_warmup=DENSE_WARMUP,
                num_samples=DENSE_DRAWS)
    mcmc.run(0)
    counts = ops.launch_counts()
    stats = mcmc.stats
    x = mcmc.get_samples(group_by_chain=True)["x"].cpu().numpy()
    mean = float(np.abs(x.mean()))
    imm = mcmc.last_state[0].adapt_state.inverse_mass_matrix
    out = {"num_warmup": DENSE_WARMUP, "num_samples": DENSE_DRAWS,
           "chain_seconds": stats["chain_seconds"],
           "num_leapfrog": stats["num_leapfrog"],
           "ms_per_leapfrog": 1e3 * stats["chain_seconds"]
           / stats["num_leapfrog"],
           "abs_mean": mean,
           "min_ess": float(min(effective_sample_size(x[..., 0]),
                                effective_sample_size(x[..., 1]))),
           "inverse_mass_matrix": imm.tolist(), "launches": counts}
    print("dense-mass NUTS:", json.dumps(out), flush=True)
    check(bool(np.all(np.isfinite(x))), "a dense-mass draw is not finite")
    check(mean < 0.2, f"|mean| {mean} >= 0.2")
    leaf_ops = ("nuts_leaf", "nuts_leaf_batch", "nuts_turning",
                "leapfrog_halfstep", "halfstep_chains")
    check(all(counts[k] == 0 for k in leaf_ops),
          f"a dense-mass run launched a diagonal leaf kernel: "
          f"{ {k: counts[k] for k in leaf_ops} }")
    return out


def tree_gates(counts, stats):
    """A NUTS run's launches: exactly one ``nuts_leaf`` a leapfrog of its
    trees; ``leapfrog_halfstep`` opens every subtree (at least one a
    transition) and the step-size search's leapfrogs (at most one a search
    evaluation); at most one ``nuts_turning`` a subtree.  A lockstep run
    (``lockstep_gates``) launches the chain-batched ops instead."""
    if stats["lockstep_leapfrogs"] is not None:
        return lockstep_gates(counts, stats)
    lf, iters = stats["num_leapfrog"], stats["num_iterations"]
    check(counts["nuts_leaf"] == lf,
          f"nuts_leaf: {counts['nuts_leaf']} launches != {lf} leapfrogs in "
          "trees")
    opens = counts["leapfrog_halfstep"]
    check(iters <= opens <= lf + stats["init_grad_evals"],
          f"leapfrog_halfstep: {opens} launches outside [{iters} "
          f"transitions, {lf} leapfrogs + {stats['init_grad_evals']} "
          "search evaluations]")
    check(counts["nuts_turning"] <= opens,
          f"nuts_turning: {counts['nuts_turning']} launches > {opens} "
          "subtrees")


def lockstep_gates(counts, stats):
    """A lockstep NUTS run's launches: exactly one ``nuts_leaf_batch`` a
    lockstep leapfrog and no one-chain ``nuts_leaf``; ``halfstep_chains``
    opens every lockstep subtree (at least one a transition, at most one a
    lockstep leapfrog); at most one ``nuts_turning_batch`` a subtree; the
    one-chain half-step only in the chains' step-size searches."""
    leaves, iters = stats["lockstep_leapfrogs"], stats["num_iterations"]
    check(counts["nuts_leaf_batch"] == leaves,
          f"nuts_leaf_batch: {counts['nuts_leaf_batch']} launches != "
          f"{leaves} lockstep leapfrogs")
    check(counts["nuts_leaf"] == 0,
          f"nuts_leaf: {counts['nuts_leaf']} one-chain launches in a "
          "lockstep run")
    opens = counts["halfstep_chains"]
    check(iters <= opens <= leaves,
          f"halfstep_chains: {opens} launches outside [{iters} "
          f"transitions, {leaves} lockstep leapfrogs]")
    check(counts["nuts_turning_batch"] <= opens,
          f"nuts_turning_batch: {counts['nuts_turning_batch']} launches > "
          f"{opens} subtrees")
    check(counts["nuts_turning"] == 0
          and counts["leapfrog_halfstep"] <= stats["init_grad_evals"],
          f"one-chain launches in a lockstep run: nuts_turning "
          f"{counts['nuts_turning']}, leapfrog_halfstep "
          f"{counts['leapfrog_halfstep']} > {stats['init_grad_evals']} "
          "search evaluations")


def _simplex_ok(x):
    return bool(torch.isfinite(x).all() and (x >= 0).all()
                and ((x.sum(-1) - 1.0).abs() <= 1e-5).all())


def run_enum_hmm(dev):
    """The fully-latent HMM through the user's entry points: NUTS moves the
    K x K transition and K x V emission rows, ``markov`` sums the hidden
    states out at every gradient through the chain kernels, one
    ``enum_chain`` and one ``enum_chain_bwd`` launch per gradient."""
    from repro_torch.bench.models import enum_hmm_data, enum_hmm_model
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    data = enum_hmm_data(ENUM_K, seed=0, T=ENUM_T, V=ENUM_V)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(enum_hmm_model, max_tree_depth=8),
                num_warmup=ENUM_WARMUP, num_samples=ENUM_DRAWS)
    mcmc.run(0, data)
    counts = ops.launch_counts()
    stats = mcmc.stats
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    lf, evals = stats["num_leapfrog"], stats["num_grad_evals"]
    theta, phi = samples["theta"], samples["phi"]
    flat = np.concatenate([v.detach().cpu().numpy().reshape(1, ENUM_DRAWS, -1)
                           for v in (theta, phi)], axis=-1)
    out = {
        "K": ENUM_K, "T": ENUM_T, "V": ENUM_V, "num_warmup": ENUM_WARMUP,
        "num_samples": ENUM_DRAWS, "max_tree_depth": 8,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"],
        "num_leapfrog": lf, "num_grad_evals": evals,
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / lf,
        "ms_per_grad_eval": 1e3 * stats["chain_seconds"] / evals,
        "host_syncs_per_leapfrog": stats["host_syncs"] / lf,
        "launches": counts,
        "kernel_launches_per_leapfrog": {
            name: counts[name] / lf for name in
            ("enum_chain", "enum_chain_bwd", "enum_contract",
             "enum_contract_bwd", "leapfrog_halfstep", "nuts_leaf",
             "nuts_turning")},
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "mean_num_steps": float(extra["num_steps"].float().mean()),
        "divergences": int(extra["diverging"].sum()),
        "min_ess": float(np.min(effective_sample_size(flat))),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    print("enumerated HMM NUTS:", json.dumps(out), flush=True)
    check(tuple(theta.shape) == (1, ENUM_DRAWS, ENUM_K, ENUM_K)
          and tuple(phi.shape) == (1, ENUM_DRAWS, ENUM_K, ENUM_V),
          f"samples have shapes {tuple(theta.shape)} {tuple(phi.shape)}")
    check(_simplex_ok(theta) and _simplex_ok(phi),
          "a theta/phi row is off the simplex or not finite")
    check(bool(torch.isfinite(extra["accept_prob"]).all()),
          "an accept_prob is not finite")
    for name in ("enum_chain", "enum_chain_bwd"):
        check(counts[name] == evals,
              f"{name}: {counts[name]} launches != {evals} gradient "
              "evaluations: the potential did not run through its kernel")
        check(counts[name] >= lf,
              f"{name}: {counts[name]} launches < {lf} leapfrogs")
    for name in ("enum_contract", "enum_contract_bwd"):
        check(counts[name] == 0,
              f"{name}: {counts[name]} one-step launches on the chain's path")
    tree_gates(counts, stats)
    out["profile"] = profile_transitions(mcmc, 3)
    print("enumerated HMM profile:", json.dumps(out["profile"]), flush=True)
    out["breakdown"] = enum_potential_breakdown(dev)
    print("enumerated HMM gradient breakdown:", json.dumps(out["breakdown"]),
          flush=True)
    return out, counts, (theta[0], phi[0])


def enum_potential_breakdown(dev, evals=10):
    """Wall ms per value-and-gradient of the enumerated HMM's potential at
    T = 1 (the model, no chain), T = 2 and the main path's T, and of the
    contraction chain alone at the main path's (T-1, K, K) (``ops.enum_chain``
    and the ``logsumexp`` after it, forward and backward); they split a
    gradient into model, contraction chain and the rest, most of it the
    ``torch.func.vmap`` transition."""
    from repro_torch.bench.models import enum_hmm_data, enum_hmm_model
    from repro_torch.core.infer import initialize_model_structure
    from repro_torch.core.infer.hmc_util import value_and_grad
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    alpha0 = torch.randn(ENUM_K, generator=gen).to(dev).requires_grad_(True)
    mats = torch.randn((ENUM_T - 1, ENUM_K, ENUM_K), generator=gen).to(
        dev).requires_grad_(True)

    def chain_grad():
        total = torch.logsumexp(ops.enum_chain(alpha0, mats), dim=-1)
        return torch.autograd.grad(total, (alpha0, mats))

    chain_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(evals):
        chain_grad()
    torch.cuda.synchronize()
    chain_ms = 1e3 * (time.perf_counter() - t0) / evals
    ms = {}
    for T in (1, 2, ENUM_T):
        data = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v for k, v in enum_hmm_data(ENUM_K, seed=0, T=T,
                                                 V=ENUM_V).items()}
        pot, _, _, _, _, proto = initialize_model_structure(
            torch.Generator().manual_seed(0), enum_hmm_model, (data,))
        pe_and_grad = value_and_grad(pot)
        z = torch.zeros_like(proto).to(dev)
        pe_and_grad(z)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(evals):
            pe_and_grad(z)
        torch.cuda.synchronize()
        ms[T] = 1e3 * (time.perf_counter() - t0) / evals
    return {"ms_per_grad_eval": {str(t): v for t, v in ms.items()},
            "model_ms": ms[1],
            "vmap_transition_ms": ms[ENUM_T] - ms[1] - chain_ms,
            "contraction_chain_ms": chain_ms,
            "t2_to_t_ms": ms[ENUM_T] - ms[2]}


def hmm_theta_gate(theta_draws, true_theta, z_max=4.0):
    """Posterior check of the semi-supervised HMM: every entry of the
    posterior mean of ``theta`` lies within ``z_max`` posterior standard
    deviations of the data-generating ``theta``.  (A fixed distance is no
    check here: about 33 supervised transitions per row leave a posterior
    sd near 0.09 per entry, and the reference's own posterior mean lies
    0.1-0.2 from the truth; tests/test_torch_hmm_gate.py runs the reference
    through this gate.)  ``theta_draws`` is ``(..., K, K)``; returns ``(ok,
    max |mean - true|, max z)``."""
    flat = np.asarray(theta_draws).reshape((-1,) + np.shape(true_theta))
    mean, sd = flat.mean(0), np.maximum(flat.std(0, ddof=1), 1e-3)
    dist = np.abs(mean - true_theta)
    z = float(np.max(dist / sd))
    return z <= z_max, float(np.max(dist)), z


# infer_discrete on the card: M posterior draws of the enumerated HMM's
# states at its data-generating theta/phi and of examples/gmm.py's
# assignments at pinned weights/mu/sigma, each marginal within DISCRETE_TOL
# of exact (a binomial sd <= 0.016 at M = 1000: 4.4 sd)
DISCRETE_M, DISCRETE_TOL = 1000, 0.07
GMM_K, GMM_N = 2, 80  # examples/gmm.py
GMM_PIN = {"weights": (0.6, 0.4), "mu": (-2.0, 2.0), "sigma": 1.5}


def hmm_smoothing(theta, phi, w):
    """Exact smoothing marginals p(z_t | w) (T, K) of the enumerated HMM by
    forward-backward in float64 on the host; the chain starts from state 0
    (``markov(step, 0, w)``: z_0 ~ theta[0])."""
    lt, lp = np.log(np.asarray(theta, np.float64)), np.log(
        np.asarray(phi, np.float64))

    def lse(a, axis):
        mx = a.max(axis, keepdims=True)
        return np.squeeze(mx, axis) + np.log(np.exp(a - mx).sum(axis))

    la = lt[0] + lp[:, w[0]]
    alphas = [la]
    for t in range(1, len(w)):
        la = lse(la[:, None] + lt, 0) + lp[:, w[t]]
        alphas.append(la)
    lb, betas = np.zeros(lt.shape[0]), [np.zeros(lt.shape[0])]
    for t in range(len(w) - 1, 0, -1):
        lb = lse(lt + lp[:, w[t]][None] + lb[None], 1)
        betas.append(lb)
    post = np.stack([a + b for a, b in zip(alphas, betas[::-1])])
    post = np.exp(post - post.max(-1, keepdims=True))
    return post / post.sum(-1, keepdims=True)


def gmm_data(seed=0):
    """examples/gmm.py's data from a numpy seed: 80 points, component 1
    with probability 0.35, means -2.5 and 2.5, sd 0.6."""
    rng = np.random.default_rng(seed)
    comp = rng.random(GMM_N) < 0.35
    return (np.where(comp, 2.5, -2.5)
            + 0.6 * rng.standard_normal(GMM_N)).astype(np.float32)


def gmm_model(x):
    """examples/gmm.py's model: the assignments are enumerated."""
    from repro_torch import core as pc
    from repro_torch.core import dist
    weights = pc.sample("weights", dist.Dirichlet(x.new_ones(GMM_K)))
    mu = pc.sample("mu", dist.Normal(x.new_zeros(GMM_K),
                                     5.0 * x.new_ones(GMM_K)).to_event(1))
    sigma = pc.sample("sigma", dist.HalfNormal(x.new_full((), 2.0)))
    with pc.plate("data", x.shape[0]):
        z = pc.sample("z", dist.Categorical(probs=weights))
        pc.sample("obs", dist.Normal(mu[z], sigma), obs=x)


def _empirical(draws, k):
    return np.stack([(draws == j).mean(0) for j in range(k)], -1)


def run_infer_discrete(dev, nuts_theta, nuts_phi):
    """``infer_discrete`` through the user's entry point on the card: the
    enumerated HMM's states at its true theta/phi (M calls, each one
    ``enum_chain`` and one ``enum_chain_sample`` launch and no
    ``enum_contract``), against float64 forward-backward; the states for
    each of the NUTS run's draws (in the support); examples/gmm.py's
    assignments at pinned parameters (M calls), against the exact
    softmax posterior."""
    from repro_torch.bench.models import enum_hmm_data, enum_hmm_model
    from repro_torch.core.handlers import substitute
    from repro_torch.core.infer import infer_discrete
    from repro_torch.kernels import ops

    data = enum_hmm_data(ENUM_K, seed=0, T=ENUM_T, V=ENUM_V)
    on_card = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
               else v for k, v in data.items()}
    pinned = substitute(enum_hmm_model, data={
        "theta": torch.from_numpy(data["true_theta"]).to(dev),
        "phi": torch.from_numpy(data["true_phi"]).to(dev)})
    gens = [torch.Generator().manual_seed(i) for i in range(DISCRETE_M)]
    infer_discrete(pinned, 10 ** 6)(on_card)  # warm: the first call's setup
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = [infer_discrete(pinned, gen)(on_card)["markov"] for gen in gens]
    torch.cuda.synchronize()
    hmm_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    states = torch.stack(draws).cpu().numpy()
    exact = hmm_smoothing(data["true_theta"], data["true_phi"], data["w"])
    hmm_err = float(np.max(np.abs(_empirical(states, ENUM_K) - exact)))
    syncs = count_syncs(lambda: infer_discrete(pinned, 0)(on_card))
    out = {"hmm": {"K": ENUM_K, "T": ENUM_T, "M": DISCRETE_M,
                   "ms_per_call": 1e3 * hmm_s / DISCRETE_M,
                   "host_syncs_per_call": syncs,
                   "launches": {n: counts[n] for n in (
                       "enum_chain", "enum_chain_sample", "enum_contract",
                       "enum_chain_bwd")},
                   "max_abs_marginal_err": hmm_err}}
    check(tuple(states.shape) == (DISCRETE_M, ENUM_T)
          and states.dtype == np.int64, f"HMM draws {states.shape}")
    check(hmm_err < DISCRETE_TOL, f"infer_discrete's HMM marginals are "
                                  f"{hmm_err} from forward-backward")
    for name, want in (("enum_chain", DISCRETE_M),
                       ("enum_chain_sample", DISCRETE_M),
                       ("enum_contract", 0)):
        check(counts[name] == want, f"{name}: {counts[name]} launches in "
                                    f"{DISCRETE_M} infer_discrete calls")
    # the NUTS run's draws: one call each
    nuts_states = []
    t0 = time.perf_counter()
    for i in range(nuts_theta.shape[0]):
        run = infer_discrete(substitute(enum_hmm_model, data={
            "theta": nuts_theta[i], "phi": nuts_phi[i]}), i)
        nuts_states.append(run(on_card)["markov"])
    nuts_states = torch.stack(nuts_states)
    out["nuts_draws"] = {"draws": int(nuts_theta.shape[0]),
                         "seconds": time.perf_counter() - t0}
    check(tuple(nuts_states.shape) == (nuts_theta.shape[0], ENUM_T)
          and bool(((nuts_states >= 0) & (nuts_states < ENUM_K)).all()),
          "infer_discrete on the NUTS draws: states out of the support")
    # examples/gmm.py at pinned parameters
    x = torch.from_numpy(gmm_data()).to(dev)
    gmm_pinned = substitute(gmm_model, data={
        k: torch.tensor(v, dtype=torch.float32, device=dev)
        for k, v in GMM_PIN.items()})
    infer_discrete(gmm_pinned, 10 ** 6)(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs = torch.stack([infer_discrete(gmm_pinned, gen)(x)["z"]
                      for gen in gens]).cpu().numpy()
    gmm_s = time.perf_counter() - t0
    xs = gmm_data().astype(np.float64)[:, None]
    mu, sd = np.array(GMM_PIN["mu"]), GMM_PIN["sigma"]
    logits = np.log(GMM_PIN["weights"])[None] - 0.5 * ((xs - mu) / sd) ** 2
    exact = np.exp(logits - logits.max(-1, keepdims=True))
    exact /= exact.sum(-1, keepdims=True)
    gmm_err = float(np.max(np.abs(_empirical(zs, GMM_K) - exact)))
    out["gmm"] = {"K": GMM_K, "N": GMM_N, "M": DISCRETE_M,
                  "ms_per_call": 1e3 * gmm_s / DISCRETE_M,
                  "max_abs_marginal_err": gmm_err,
                  "uncertain_points": int(((exact > 0.05)
                                           & (exact < 0.95)).any(-1).sum())}
    check(zs.shape == (DISCRETE_M, GMM_N), f"GMM draws {zs.shape}")
    check(gmm_err < DISCRETE_TOL, f"infer_discrete's GMM marginals are "
                                  f"{gmm_err} from the exact posterior")
    print("infer_discrete:", json.dumps(out), flush=True)
    return out, counts


def run_hmm(dev):
    """The paper's semi-supervised HMM: a hand-written forward pass (plain
    PyTorch logsumexp products, as the JAX model's lax.scan is plain jnp)
    under NUTS."""
    from repro_torch.bench.models import hmm_data, hmm_model
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    data = hmm_data(seed=0, T=HMM_T, T_sup=HMM_T_SUP, K=HMM_K, V=HMM_V)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(hmm_model), num_warmup=HMM_WARMUP,
                num_samples=HMM_DRAWS)
    mcmc.run(0, data)
    counts = ops.launch_counts()
    stats = mcmc.stats
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    lf = stats["num_leapfrog"]
    theta, phi = samples["theta"], samples["phi"]
    th = theta.detach().cpu().numpy()
    ok, err, z = hmm_theta_gate(th, data["true_theta"])
    out = {
        "T": HMM_T, "T_sup": HMM_T_SUP, "K": HMM_K, "V": HMM_V,
        "num_warmup": HMM_WARMUP, "num_samples": HMM_DRAWS,
        "chain_seconds": stats["chain_seconds"], "num_leapfrog": lf,
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / lf,
        "host_syncs_per_leapfrog": stats["host_syncs"] / lf,
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "divergences": int(extra["diverging"].sum()),
        "max_abs_posterior_mean_theta_minus_true": err,
        "max_z_posterior_mean_theta_minus_true": z,
        "min_ess_theta": float(np.min(effective_sample_size(th))),
    }
    print("semi-supervised HMM NUTS:", json.dumps(out), flush=True)
    check(_simplex_ok(theta) and _simplex_ok(phi),
          "a theta/phi row is off the simplex or not finite")
    check(bool(torch.isfinite(extra["accept_prob"]).all()),
          "an accept_prob is not finite")
    check(ok, f"posterior mean of theta is {z} posterior sds ({err}) from "
              "the data-generating theta")
    tree_gates(counts, stats)
    return out, counts


def _ensemble_summary(mcmc, data, counts, chain_evals, extra_keys=()):
    """What an ensemble phase measured, and the gates every phase shares:
    finite draws of the expected shape, no divergence after warmup, the
    posterior mean within 0.05 of ``true_w``, the fused potential's prior
    batched by ``torch.func.vmap``, and every GLM launch accounted for: one
    per ensemble evaluation (all chains in one launch), one per evaluation
    of the initial-point and step-size searches, and the fused potential's
    closing check at setup (``core/infer/glm.py``); its chain evaluations
    (``chain_evals``) one per chain and evaluation, plus that check."""
    from repro_torch.core.infer import effective_sample_size, gelman_rubin
    stats = mcmc.stats
    chains = mcmc.num_chains
    w = mcmc.get_samples(group_by_chain=True)["w"].detach().cpu().numpy()
    extra = mcmc.get_extra_fields(group_by_chain=True)
    post_err = float(np.max(np.abs(w.mean((0, 1)) - data["true_w"])))
    divergences = int(extra["diverging"].sum())
    evals = stats["num_grad_evals"]
    out = {
        "num_chains": chains, "num_warmup": mcmc.num_warmup,
        "num_samples": mcmc.num_samples,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"],
        "num_iterations": stats["num_iterations"],
        "num_leapfrog": stats["num_leapfrog"],
        "num_grad_evals": evals, "init_grad_evals": stats["init_grad_evals"],
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"]
        / stats["num_leapfrog"],
        "ms_per_iteration": 1e3 * stats["chain_seconds"]
        / stats["num_iterations"],
        "ms_per_grad_eval": 1e3 * stats["chain_seconds"] / evals,
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_iteration": stats["host_syncs"]
        / stats["num_iterations"],
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "step_size": float(extra["step_size"][0, -1]),
        "divergences": divergences,
        "max_abs_posterior_mean_minus_true_w": post_err,
        "max_split_rhat": float(np.max(gelman_rubin(w))),
        "min_ess": float(np.min(effective_sample_size(w))),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "glm_prior": stats["glm_prior"],
        "glm_prior_batch": stats["glm_prior_batch"],
        "glm_chain_evals": chain_evals,
    }
    for key in extra_keys:
        out[key] = float(extra[key].float().mean())
    check(w.shape == (chains, mcmc.num_samples, D) and np.all(np.isfinite(w)),
          f"samples have shape {w.shape} or are not finite")
    check(divergences == 0, f"{divergences} divergent transitions after "
                            "warmup")
    check(post_err < 0.05, f"posterior mean is {post_err} from true_w")
    check(stats["glm_prior"] == "slim", "the fused potential's prior term "
          f"runs on the {stats['glm_prior']} data, not on 0 rows")
    check(evals == chains * stats["num_leapfrog"] + stats["init_grad_evals"],
          f"{evals} gradient evaluations != {chains} chains x "
          f"{stats['num_leapfrog']} + {stats['init_grad_evals']} (searches)")
    check(stats["glm_prior_batch"] == "vmap", "the fused potential's "
          f"batched entry runs its prior as a {stats['glm_prior_batch']}, "
          "not under torch.func.vmap")
    init = stats["init_grad_evals"]
    batched, rest = divmod(evals - init, chains)
    check(rest == 0, f"{evals - init} ensemble gradient evaluations are not "
                     f"a multiple of {chains} chains")
    check(chain_evals == evals + 1,
          f"glm_potential_grad: {chain_evals} chain evaluations != {evals} "
          "gradient evaluations + 1 (the setup's check)")
    check(counts["glm_potential_grad"] == batched + init + 1,
          f"glm_potential_grad: {counts['glm_potential_grad']} launches != "
          f"{batched} ensemble evaluations + {init} search evaluations + 1 "
          "(the setup's check)")
    out["glm_launches_per_ensemble_eval"] = \
        (counts["glm_potential_grad"] - init - 1) / batched
    return out, w


# ChEES's kernels and a substring of each one's device kernel name
CHEES_KERNELS = {"chees_open": "leapfrog_batch_kernel<float, true>",
                 "leapfrog_halfstep_batch":
                     "leapfrog_batch_kernel<float, false>",
                 "chees_accept": "chees_accept_kernel",
                 "glm_potential_grad": "glm_chains_kernel"}


def run_chees(dev, data):
    """``MCMC(ChEES(logreg_model_glm), 300, 1500, num_chains=8)`` on the
    581,012 x 54 data: the trajectory replayed from two CUDA graphs (one
    ``chees_open`` and the potential, then the batch leapfrog and the
    potential ``num_steps - 1`` times), the 8 chains' gradients in one GLM
    launch an evaluation, one ``chees_accept`` a transition; over 20
    profiled transitions of the same setting in a fresh process the
    profiler's count of each of these kernels equals its launch counter's
    increase."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, ChEES
    from repro_torch.kernels import ops
    from repro_torch.kernels.glm_potential import glm_potential_grad_cuda

    ops.reset_launch_counts()
    mcmc = MCMC(ChEES(logreg_model_glm), num_warmup=CHEES_WARMUP,
                num_samples=CHEES_DRAWS, num_chains=CHEES_CHAINS)
    mcmc.run(0, data["x"], y=data["y"])
    counts = ops.launch_counts()
    chain_evals = glm_potential_grad_cuda.chain_evals
    out, _ = _ensemble_summary(mcmc, data, counts, chain_evals,
                               ("trajectory_length", "num_steps"))
    steps = mcmc.get_extra_fields(group_by_chain=True)["num_steps"]
    stats = mcmc.stats
    for key in ("trajectory_graph", "graph_replays", "graph_eager_bodies",
                "graph_capture_seconds"):
        out[key] = stats[key]
    iterations, leapfrogs = out["num_iterations"], out["num_leapfrog"]
    for name in ("chees_open", "leapfrog_halfstep_batch", "chees_accept"):
        out[f"{name}_per_leapfrog"] = counts[name] / leapfrogs
    print("ChEES:", json.dumps(out), flush=True)
    check(bool((steps == steps[:1]).all()),
          "the chains report different num_steps at some draw: not lockstep")
    check(out["max_split_rhat"] < RHAT_MAX,
          f"max split R-hat {out['max_split_rhat']} >= {RHAT_MAX}")
    check(stats["trajectory_graph"] is True,
          "ChEES's trajectory does not replay from CUDA graphs")
    for name, want in (("chees_open", iterations),
                       ("chees_accept", iterations),
                       ("leapfrog_halfstep_batch", leapfrogs - iterations)):
        check(counts[name] == want,
              f"{name}: {counts[name]} launches != {want}")
    replays, eager = stats["graph_replays"], stats["graph_eager_bodies"]
    check(replays["opening"] + eager["opening"] == iterations and
          replays["interior"] + eager["interior"] == leapfrogs - iterations,
          f"graph replays {replays} and eager runs {eager} do not make "
          f"{iterations} openings and {leapfrogs - iterations} interior "
          "leapfrogs")
    out["profile"] = profile_transitions(mcmc, 20, CHEES_KERNELS)
    print("ChEES profile:", json.dumps(out["profile"]), flush=True)
    # the count check in a fresh process: late in this long one the
    # profiler loses records (PERF.md, lesson 4; here ~19 of ~1,430 device
    # records of the window, once a chees_open)
    kernel_counts = in_fresh_process("chees_profile_check")
    out["profile"]["kernel_counts_fresh_process"] = kernel_counts
    print("ChEES kernel counts (fresh process):", json.dumps(kernel_counts),
          flush=True)
    check(kernel_counts and all(v["profiler"] == v["counter"]
                                for v in kernel_counts.values()),
          f"the profiler's kernel counts differ from the launch counters: "
          f"{kernel_counts}")
    return out, counts


def chees_profile_check():
    """ChEES at ``run_chees``'s setting (the draws cut to 20) and 20
    profiled transitions after it: per ChEES kernel, the profiler's count
    and its launch counter's increase (``profile_transitions``)."""
    from repro_torch.bench.models import covtype_data, logreg_model_glm
    from repro_torch.core.infer import MCMC, ChEES
    data = covtype_data(seed=0, n=N, d=D)
    mcmc = MCMC(ChEES(logreg_model_glm), num_warmup=CHEES_WARMUP,
                num_samples=20, num_chains=CHEES_CHAINS)
    mcmc.run(0, data["x"], y=data["y"])
    return profile_transitions(mcmc, 20, CHEES_KERNELS)["kernel_counts"]


def in_fresh_process(name, *args):
    """``chip_smoke.<name>(*args)`` run in a new Python process (the kernels
    are built already; ``args`` are JSON values); its JSON result."""
    code = ("import json, sys; sys.path.insert(0, %r); import chip_smoke; "
            "print('RESULT ' + json.dumps(chip_smoke.%s(*json.loads(%r))))"
            % (HERE, name, json.dumps(args)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=HERE)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    check(proc.returncode == 0 and bool(lines),
          f"{name} failed in its process (exit {proc.returncode}):\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def run_mrw(dev, data, algo, init_w=None):
    """``MCMC(MALA | RWM(logreg_model_glm), 500, 500, num_chains=16)`` on the
    581,012 x 54 data, one ``mala_step`` launch per iteration (RWM's without
    the gradient operand); RWM starts every chain at ``init_w`` through the
    entry point's ``init_params``."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MALA, MCMC, RWM
    from repro_torch.kernels import ops
    from repro_torch.kernels.glm_potential import glm_potential_grad_cuda
    from repro_torch.kernels.rwm_mala import mala_step_cuda

    kernel = {"MALA": MALA, "RWM": RWM}[algo]
    ops.reset_launch_counts()
    mcmc = MCMC(kernel(logreg_model_glm), num_warmup=MRW_WARMUP,
                num_samples=MRW_DRAWS, num_chains=MRW_CHAINS)
    init = None if init_w is None else {"w": init_w}
    mcmc.run(0, data["x"], y=data["y"], init_params=init)
    counts = ops.launch_counts()
    chain_evals = glm_potential_grad_cuda.chain_evals
    without_grad = mala_step_cuda.launches_without_grad
    out, w = _ensemble_summary(mcmc, data, counts, chain_evals)
    out["mala_step_launches_without_grad"] = without_grad
    print(f"{algo}:", json.dumps(out), flush=True)
    iterations = MRW_WARMUP + MRW_DRAWS
    for name in ("mala_step", "mala_accept"):
        check(counts[name] == iterations,
              f"{name}: {counts[name]} launches != {iterations} iterations")
    want = iterations if algo == "RWM" else 0
    check(without_grad == want, f"{algo}: {without_grad} launches of the "
          f"no-gradient variant, expected {want}")
    out["profile"] = profile_transitions(mcmc, 20)
    print(f"{algo} profile:", json.dumps(out["profile"]), flush=True)
    return out, counts, w.mean((0, 1))


def ensemble_kernel_rows(checks, timing, phases):
    """The kernel-table rows of the batch leapfrog, ``mala_step``,
    ``mala_accept``, ``chees_open`` and ``chees_accept``: the main shape's
    times (the merged kick, MALA's variant, MALA's accept after warmup,
    ChEES's close after warmup) and bound, the other variants' and the
    large shape's beside them, and the launches of every phase that ran
    the kernel (``phases``: name -> {phase: (summary, launch counts)})."""
    from repro_torch.kernels.ops import FUSED, SPECS
    rows = []
    for name, source, variant, shape in (
            ("leapfrog_halfstep_batch", "leapfrog_batch.cu", "kick=1.0",
             ENS_CHEES),
            ("mala_step", "mala_step.cu", "MALA", ENS_MRW),
            ("mala_accept", "mala_step.cu", "MALA, after warmup", ENS_MRW),
            ("chees_open", "leapfrog_batch.cu", "", ENS_CHEES),
            ("chees_accept", "chees.cu", "sampling", ENS_CHEES)):
        times, (bound_ms, bound_by), err = timing[(name, variant, shape)]
        runs = phases[name]
        spec = SPECS.get(name) or FUSED[name]
        rows.append({
            "name": name, "route": spec.route,
            "source": "src/repro_torch/csrc/" + source,
            "replaces": spec.replaces,
            "launches": sum(c[name] for _, c in runs.values()),
            "launches_by_phase": {p: c[name] for p, (_, c) in runs.items()},
            "launches_per_iteration": {
                p: c[name] / o["num_iterations"]
                for p, (o, c) in runs.items()},
            "launches_per_leapfrog": {
                p: c[name] / o["num_leapfrog"]
                for p, (o, c) in runs.items()},
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "none: no single PyTorch call computes it",
            "shape": list(shape), "variant": variant,
            "variants": {
                f"{v} {list(sh)}": {"ms": t["ms"], "plain_ms": t["plain_ms"],
                                    "call_ms": t["call_ms"], "bound_ms": b[0],
                                    "bound_by": b[1]}
                for (n, v, sh), (t, b, _) in timing.items() if n == name}})
    return rows


# ---------------------------------------------------------------------------
# the LM serving slice: Qwen3-8B prefill and KV-cache decode
# ---------------------------------------------------------------------------

def _bf16_close(got, want):
    """Elementwise within one bfloat16 rounding step of the float32-computed
    value (``kernels/ops.py:BF16_RTOL``); returns (ok, max abs
    error, largest error / bound)."""
    from repro_torch.kernels.ops import BF16_ATOL, BF16_RTOL
    err = (got.float() - want.float()).abs()
    bound_ = BF16_RTOL * want.float().abs() + BF16_ATOL
    return bool((err <= bound_).all()), float(err.max()), \
        float((err / bound_).max())


def _kernel_case(kernel, plain, dtype, tol):
    """Run a kernel and its plain version on the same inputs; the outputs
    (tuples) must agree within ``tol`` (float32) or one bfloat16 step."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    errs, ok = [], True
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            err = float((a - b).abs().max())
            ok = ok and err <= tol
        else:
            close, err, _ = _bf16_close(a, b)
            ok = ok and close
        errs.append(err)
    return ok, max(errs)


def rmsnorm_bound(rows, d, dtype):
    """x read and out written once, the float32 weight row; ~3 float32
    operations per element (square-accumulate, two products)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return bound(2 * rows * d * itemsize + 4 * d, 3 * rows * d,
                 torch.float32)


def attention_bound(B, S, H, K, dq, dv, causal, dtype):
    """q, k, v read once, o and lse written once; the score entries this
    mask keeps (S (S + 1) / 2 per head when causal), each a dq-long product
    and a dv-long update (2 operations per multiply-add), at the peak rate
    of the inputs' type (bf16 tensor cores for bf16)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * B * S * (H * dq + K * dq + K * dv + H * dv) \
        + 4 * B * H * S
    entries = B * H * (S * (S + 1) // 2 if causal else S * S)
    return bound(nbytes, entries * (2 * dq + 2 * dv), dtype)


def cold_device_ms(fn, x, iters):
    """:func:`device_ms` of ``fn(x_k)`` with the input rotated over copies
    ``x_k`` of ``x`` that together hold at least ``COLD_BYTES``, so every
    replayed call finds its input out of the 50 MB L2 and reads it from
    HBM (a warm replay of one 16 MB input reads it from L2)."""
    copies = [x.clone() for _ in range(
        max(2, -(-COLD_BYTES // (x.numel() * x.element_size()))))]
    turn = itertools.count()
    return device_ms(lambda: fn(copies[next(turn) % len(copies)]), iters)


def rms_kernel_checks(dev):
    """``rmsnorm_cuda`` against its plain version in float32 (OP_TABLE's
    2e-5) and bfloat16 (one rounding step) on ``RMS_SHAPES``; times and
    ``F.rms_norm``'s (the library yardstick) at ``RMS_TIMED`` in bfloat16,
    warm (the input in L2 across replays), and at the main shape also cold
    (:func:`cold_device_ms`), kernel and library alike."""
    import torch.nn.functional as F

    from repro_torch.kernels.ops import SPECS
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref

    results, timing = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(RMS_SHAPES):
            gen = torch.Generator().manual_seed(seed)
            x = torch.randn(shape, generator=gen).to(dtype).to(dev)
            w = (torch.rand(shape[-1], generator=gen) + 0.5).to(dev)
            ok, err = _kernel_case(lambda: (rmsnorm_cuda(x, w),),
                                   lambda: (rmsnorm_ref(x, w),), dtype,
                                   SPECS["rmsnorm"].tol)
            results.append({"name": "rmsnorm", "shape": list(shape),
                            "dtype": str(dtype), "max_abs_err": err,
                            "within_bound": ok})
            check(ok, f"rmsnorm kernel disagrees at {shape} {dtype}: {err}")
            if dtype == torch.bfloat16 and shape in RMS_TIMED:
                rows, d = math.prod(shape[:-1]), shape[-1]
                t = timings(lambda: rmsnorm_cuda(x, w),
                            lambda: rmsnorm_ref(x, w), 100)
                wl = w.to(dtype)
                t["library_ms"] = device_ms(
                    lambda: F.rms_norm(x, (d,), wl, 1e-6), 100)
                if shape == RMS_TIMED[0]:
                    t["cold_ms"] = cold_device_ms(
                        lambda a: rmsnorm_cuda(a, w), x, 100)
                    t["library_cold_ms"] = cold_device_ms(
                        lambda a: F.rms_norm(a, (d,), wl, 1e-6), x, 100)
                timing[("rmsnorm", shape)] = (t, rmsnorm_bound(rows, d,
                                                               dtype), err)
    return results, timing


def lm_kernel_checks(dev):
    """:func:`rms_kernel_checks`, then ``flash_attention_cuda`` against its
    plain version in float32 (OP_TABLE's 2e-4) and bfloat16 (one rounding
    step) on the LM's shapes and ragged ones: causal and not, MHA, GQA and
    MQA, dq != dv, S not a multiple of the tile; timed beside
    ``F.scaled_dot_product_attention`` (the library yardstick) at the main
    path's shape in bfloat16 and at gemma-2b's training shape
    (``ATTN_BWD_MAIN``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.kernels.ops import SPECS

    results, timing = rms_kernel_checks(dev)
    for dtype in (torch.float32, torch.bfloat16):
        for seed, (B, S, H, K, dq, dv, causal) in enumerate(ATTN_SHAPES):
            gen = torch.Generator().manual_seed(100 + seed)
            q, k, v = (torch.randn(s, generator=gen).to(dtype).to(dev)
                       for s in ((B, S, H, dq), (B, S, K, dq), (B, S, K, dv)))
            ok, err = _kernel_case(
                lambda: flash_attention_cuda(q, k, v, causal=causal),
                lambda: flash_attention_ref(q, k, v, causal=causal), dtype,
                SPECS["attention"].tol)
            shape = [B, S, H, K, dq, dv]
            results.append({"name": "attention", "shape": shape,
                            "causal": causal, "dtype": str(dtype),
                            "max_abs_err": err, "within_bound": ok})
            check(ok, f"flash_attention kernel disagrees at {shape} causal="
                      f"{causal} {dtype}: {err}")
            if dtype == torch.bfloat16 and (B, S, H, K, dq, dv, causal) \
                    == ATTN_MAIN:
                t = timings(lambda: flash_attention_cuda(q, k, v),
                            lambda: flash_attention_ref(q, k, v), 10)
                qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
                t["library_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
                timing[("attention", ATTN_MAIN)] = (
                    t, attention_bound(B, S, H, K, dq, dv, causal, dtype),
                    err)
    # the forward at gemma-2b's training shape (72 launches a step), bf16
    B, S, H, K, dq, dv, causal = ATTN_BWD_MAIN
    gen = torch.Generator().manual_seed(100 + len(ATTN_SHAPES))
    q, k, v = (torch.randn(s, generator=gen).to(torch.bfloat16).to(dev)
               for s in ((B, S, H, dq), (B, S, K, dq), (B, S, K, dv)))
    ok, err = _kernel_case(
        lambda: flash_attention_cuda(q, k, v, causal=causal),
        lambda: flash_attention_ref(q, k, v, causal=causal), torch.bfloat16,
        SPECS["attention"].tol)
    results.append({"name": "attention", "shape": list(ATTN_BWD_MAIN[:6]),
                    "causal": causal, "dtype": str(torch.bfloat16),
                    "max_abs_err": err, "within_bound": ok})
    check(ok, f"flash_attention kernel disagrees at {ATTN_BWD_MAIN}: {err}")
    t = timings(lambda: flash_attention_cuda(q, k, v, causal=causal),
                lambda: flash_attention_ref(q, k, v, causal=causal), 10)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    t["library_ms"] = device_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
    timing[("attention", ATTN_BWD_MAIN)] = (
        t, attention_bound(B, S, H, K, dq, dv, causal, torch.bfloat16), err)
    return results, timing


def _gen_tokens(vocab, batch, length, dev):
    """Prompts from numpy seed 1 in [3, vocab), as the launcher makes them."""
    prompt = np.random.default_rng(1).integers(3, vocab, (batch, length))
    return torch.from_numpy(prompt.astype(np.int32)).to(dev)


def device_profile(fn, calls):
    """Device busy share of ``calls`` calls of ``fn`` under
    ``torch.profiler``, device ms per call and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(getattr(a, "self_device_time_total", 0.0), a.count, a.key)
            for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        return {"device_busy_share": None,
                "note": "the profiler recorded no device time"}
    return {
        "calls": calls, "wall_ms_per_call_profiled": wall_us / 1e3 / calls,
        "device_busy_ms_per_call": busy_us / 1e3 / calls,
        "device_busy_share": busy_us / wall_us,
        "device_kernels_per_call": sum(r[1] for r in rows) / calls,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_call": t / 1e3 / calls,
             "launches_per_call": c / calls}
            for t, c, k in sorted(rows, reverse=True)[:8]]}


def kernel_split(fn, calls):
    """Device ms and launches per call of each kernel that ``fn`` launches,
    from :func:`device_profile` (the top 8); launches below the kernel's
    own count per call mean the profiler lost records."""
    prof = device_profile(fn, calls)
    return {k["name"]: {"ms": k["ms_per_call"],
                        "launches": k["launches_per_call"]}
            for k in prof.get("top_device_kernels", [])}


def backward_kernel_split(dev):
    """The device time of each kernel inside one bf16 call of the dq pass
    (the delta kernel and ``dq_tc_kernel``) at ``ATTN_BWD_MAIN`` and of the
    rmsnorm backward (the partials kernel and their sum) at
    ``RMS_BWD_MAIN``.  Run right after the build: later in the process the
    profiler lost records of such short calls."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, H, K, dq, dv, causal = ATTN_BWD_MAIN
    q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16) for s in ((B, S, H, dq), (B, S, K, dq), (B, S, K, dv),
                                  (B, S, H, dv)))
    o, lse = fl.flash_attention_cuda(q, k, v, causal=causal)
    x, g = (torch.randn(RMS_BWD_MAIN, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    w = torch.rand(RMS_BWD_MAIN[-1], generator=gen, device=dev) + 0.5
    return {"attention_dq": kernel_split(
        lambda: fl.flash_attention_dq_cuda(q, k, v, o, lse, do, causal), 50),
        "rmsnorm_bwd": kernel_split(lambda: rmsnorm_bwd_cuda(x, w, g), 200)}


def count_syncs(fn):
    """Synchronizing CUDA calls made by ``fn`` (the host waiting for the
    card), counted through ``torch.cuda.set_sync_debug_mode``'s warnings."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def decode_breakdown(lm, w, prompt, steps):
    """Wall ms of ``steps`` decode tokens split into the model (host time to
    issue ``decode_step``, then the wait for the card to finish it) and the
    ``next_token`` sample site (host-drawn uniforms copied to the card,
    argmax), each ended by a synchronize.  Decode attends over the whole
    cache under a mask, so its cost does not depend on the position."""
    from repro_torch.core import dist
    from repro_torch.core.primitives import sample

    B = prompt.shape[0]
    cache = lm.init_cache(B, prompt.shape[1] + LM_TOKENS, device=prompt.device)
    issue, wait, draw = [], [], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(w, prompt[:, t:t + 1], cache, t)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sample("next_token", dist.Categorical(logits=logits / 1.0),
               generator=torch.Generator().manual_seed(t))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        issue.append(t1 - t0)
        wait.append(t2 - t1)
        draw.append(t3 - t2)
    ms = lambda xs: 1e3 * float(np.median(xs))  # noqa: E731
    return {"steps": steps, "model_issue_ms": ms(issue),
            "model_wait_ms": ms(wait),
            "model_ms": ms([a + b for a, b in zip(issue, wait)]),
            "sampling_ms": ms(draw)}


def run_lm(dev):
    """The full Qwen3-8B (36 layers, bf16, params drawn on the card from
    seed 0): ``make_prefill_step`` at B = 4, P = 512, then the launcher's
    serving loop (``serve.generate``: the prompt teacher-forced through
    ``serve_step``, then 32 sampled tokens), each with the launch counters
    set to 0 before and read after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import LM, count_params

    cfg = get_config("qwen3-8b")
    lm = LM(cfg)
    reset_peak(dev)
    t0 = time.perf_counter()
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(cfg)
    B, P, V = LM_BATCH, LM_PROMPT, cfg.vocab_size
    prompt = _gen_tokens(V, B, P, dev)
    prefill = make_prefill_step(lm)

    ops.reset_launch_counts()
    last = prefill(w, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_counts = ops.launch_counts()
    t0 = time.perf_counter()
    for _ in range(LM_PREFILL_REPS):
        prefill(w, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0) / LM_PREFILL_REPS

    ops.reset_launch_counts()
    result = serve.generate(lm, w, prompt, LM_TOKENS, temperature=1.0)
    serve_counts = ops.launch_counts()
    steps_run = P - 1 + LM_TOKENS
    first, seq = result["first_logits"], result["tokens"]

    diff = (first.float() - last.float())
    rel_rms = float(diff.pow(2).mean().sqrt()
                    / last.float().pow(2).mean().sqrt())
    top1 = (first.argmax(-1) == last.argmax(-1)).float().mean()
    out = {
        "arch": cfg.name, "params": n_params, "batch": B, "prompt_len": P,
        "new_tokens": LM_TOKENS, "init_seconds": init_s,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
        "prefill_launches": prefill_counts,
        "teacher_forced_ms_per_step": 1e3 * result["teacher_forced_seconds"]
        / (P - 1),
        "sampled_ms_per_token": 1e3 * result["sampled_seconds"] / LM_TOKENS,
        "sampled_tokens_per_s": B * LM_TOKENS / result["sampled_seconds"],
        "serve_launches": serve_counts, "serve_steps": steps_run,
        "prefill_vs_decode_logits": {
            "max_abs_err": float(diff.abs().max()), "rel_rms_err": rel_rms,
            "rel_rms_bound": LM_REL_RMS_MAX,
            "top1_agreement": float(top1),
            "logit_rms": float(last.float().pow(2).mean().sqrt())},
    }
    print("Qwen3-8B serving:", json.dumps(out), flush=True)
    check(tuple(last.shape) == (B, V) and tuple(first.shape) == (B, V),
          f"logits have shapes {tuple(last.shape)}, {tuple(first.shape)}")
    check(bool(torch.isfinite(last).all() and torch.isfinite(first).all()),
          "a prefill or decode logit is not finite")
    check(tuple(seq.shape) == (B, P + LM_TOKENS)
          and bool(((seq >= 0) & (seq < V)).all()),
          f"tokens of shape {tuple(seq.shape)} or outside [0, {V})")
    check(torch.equal(seq[:, :P], prompt), "the prompt was not kept")
    check(rel_rms <= LM_REL_RMS_MAX,
          f"prefill and teacher-forced decode logits at P-1 differ by "
          f"{rel_rms} (relative rms) > {LM_REL_RMS_MAX}")
    per_pass = 4 * cfg.num_layers + 1
    check(prefill_counts["rmsnorm"] == per_pass
          and prefill_counts["attention"] == cfg.num_layers,
          f"prefill launched rmsnorm {prefill_counts['rmsnorm']} and "
          f"attention {prefill_counts['attention']} times, not {per_pass} "
          f"and {cfg.num_layers}")
    check(serve_counts["rmsnorm"] == per_pass * steps_run
          and serve_counts["attention"] == 0,
          f"serving launched rmsnorm {serve_counts['rmsnorm']} and attention "
          f"{serve_counts['attention']} times over {steps_run} steps, not "
          f"{per_pass} and 0 per step")

    out["decode_breakdown"] = decode_breakdown(lm, w, prompt, 16)
    step = make_serve_step(lm)
    cache = lm.init_cache(B, P + LM_TOKENS, device=dev)
    tok = prompt[:, :1]

    def serve_one():
        step(w, cache, tok, 0, torch.Generator().manual_seed(0))
    out["decode_breakdown"]["host_syncs_per_step"] = count_syncs(serve_one)
    out["prefill_host_syncs"] = count_syncs(
        lambda: prefill(w, {"tokens": prompt}))
    out["decode_profile"] = device_profile(serve_one, 8)
    out["prefill_profile"] = device_profile(
        lambda: prefill(w, {"tokens": prompt}), 2)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print("Qwen3-8B breakdown:", json.dumps(
        {k: out[k] for k in ("decode_breakdown", "decode_profile",
                             "prefill_profile", "prefill_host_syncs",
                             "peak_mem_gb")}), flush=True)
    return out


def run_lm_f32_check(dev):
    """A full-width, 2-layer float32 Qwen3 (params from seed 0 on the card)
    through the kernels and through the plain versions on the card
    (``ops.SPECS`` pointed at the plain versions for the second run): the
    prefill's last logits, and LM_F32_DECODE_STEPS decode steps of the
    prompt teacher-forced into a fresh cache (the norms at the decode rows).
    In float32 the two differ only by the kernels' own rounding, so the
    bound is tight: LM_F32_REL_TOL of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import LM

    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=2,
                              dtype="float32")
    lm = LM(cfg)
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    prompt = _gen_tokens(cfg.vocab_size, LM_BATCH, LM_PROMPT, dev)
    prefill = make_prefill_step(lm)
    steps = LM_F32_DECODE_STEPS

    def decode():
        cache = lm.init_cache(LM_BATCH, steps, device=dev)
        logits = []
        for t in range(steps):
            lg, cache = lm.decode_step(w, prompt[:, t:t + 1], cache, t)
            logits.append(lg)
        return torch.stack(logits)

    ops.reset_launch_counts()
    got = prefill(w, {"tokens": prompt})
    prefill_counts = ops.launch_counts()
    ops.reset_launch_counts()
    got_dec = decode()
    decode_counts = ops.launch_counts()
    saved = dict(ops.SPECS)
    try:
        for name in ("rmsnorm", "attention"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        want = prefill(w, {"tokens": prompt})
        want_dec = decode()
    finally:
        ops.SPECS.update(saved)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = LM_F32_REL_TOL * max(1.0, float(want.abs().max()))
    dec_err = float((got_dec - want_dec).abs().max())
    dec_tol = LM_F32_REL_TOL * max(1.0, float(want_dec.abs().max()))
    out = {"layers": 2, "dtype": "float32", "max_abs_err": err, "tol": tol,
           "max_abs_logit": float(want.abs().max()),
           "launches": prefill_counts, "decode_steps": steps,
           "decode_max_abs_err": dec_err, "decode_tol": dec_tol,
           "decode_launches": decode_counts}
    print("Qwen3 2-layer float32 kernels vs plain:", json.dumps(out),
          flush=True)
    check(bool(torch.isfinite(got).all() and torch.isfinite(got_dec).all()),
          "a float32 logit is not finite")
    check(err <= tol, f"float32 prefill through the kernels differs from the "
                      f"plain versions by {err} > {tol}")
    check(dec_err <= dec_tol, f"float32 decode through the kernels differs "
                              f"from the plain versions by {dec_err} > "
                              f"{dec_tol}")
    check(prefill_counts["rmsnorm"] == 9 and prefill_counts["attention"] == 2,
          f"2-layer prefill launched {prefill_counts}")
    check(decode_counts["rmsnorm"] == 9 * steps
          and decode_counts["attention"] == 0,
          f"{steps} 2-layer decode steps launched {decode_counts}")
    return out


def lm_kernel_rows(checks, timing, lm, train, ssm):
    """The kernel-table rows of ``rmsnorm`` and ``attention``: main-shape
    times and bounds, variants beside them, and the launches of the serving
    phases, of the training run and of the mamba2 serving phases."""
    from repro_torch.kernels.ops import SPECS
    rows = []
    for name, source, key in (
            ("rmsnorm", "rmsnorm.cu", ("rmsnorm", RMS_TIMED[0])),
            ("attention", "flash_attention.cu", ("attention", ATTN_MAIN))):
        times, (bound_ms, bound_by), err = timing[key]
        by_phase = {"prefill": lm["prefill_launches"][name],
                    "serve": lm["serve_launches"][name],
                    "train": train["launches"][name],
                    "mamba2_prefill": ssm["prefill_launches"].get(name, 0),
                    "mamba2_serve": ssm["serve_launches"].get(name, 0)}
        row = {
            "name": name, "route": SPECS[name].route,
            "source": "src/repro_torch/csrc/" + source,
            "replaces": SPECS[name].replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "launches_per_prefill": by_phase["prefill"],
            "launches_per_decode_step": by_phase["serve"] / lm["serve_steps"],
            "launches_per_train_step": train["launches_per_step"][name],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"],
            "library": {"rmsnorm": "torch.nn.functional.rms_norm",
                        "attention": "torch.nn.functional."
                        "scaled_dot_product_attention(enable_gqa=True)"}[name],
            "shape": list(key[1]), "dtype": "bfloat16"}
        if name == "rmsnorm":  # the input read from HBM, not L2
            row["cold_ms"] = times["cold_ms"]
            row["library_cold_ms"] = times["library_cold_ms"]
        row["variants"] = {
            str(list(shape)): {"ms": t["ms"], "plain_ms": t["plain_ms"],
                               "library_ms": t["library_ms"],
                               "bound_ms": b[0], "bound_by": b[1]}
            for (n, shape), (t, b, _) in timing.items()
            if n == name and shape != key[1]}
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the training slice: gemma-2b MAP training
# ---------------------------------------------------------------------------

def rmsnorm_bwd_bound(rows, d, dtype):
    """x and g read, dx written once, the weight read and dw written; ~8
    float32 operations per element."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return bound(3 * rows * d * itemsize + 8 * d, 8 * rows * d,
                 torch.float32)


def attention_bwd_bound(B, S, H, K, dq, dv, causal, dtype, which):
    """The dq pass reads q, k, v, o, dO and lse and writes dq and delta;
    the dkv pass reads q, k, v, dO, lse and delta and writes dk and dv.  Per
    score entry the mask keeps, the dq pass multiplies 2 dq + dv long
    vectors (s, dq; dp) and the dkv pass 2 dq + 2 dv (s, dk; dp, dv), 2
    operations per multiply-add, at the inputs' type's peak rate."""
    it = torch.tensor([], dtype=dtype).element_size()
    q, k, v, o = B * S * H * dq, B * S * K * dq, B * S * K * dv, B * S * H * dv
    rows = 4 * B * H * S
    entries = B * H * (S * (S + 1) // 2 if causal else S * S)
    if which == "dq":
        return bound(it * (q + k + v + 2 * o + q) + 2 * rows,
                     entries * 2 * (2 * dq + dv), dtype)
    return bound(it * (q + k + v + o + k + v) + 2 * rows,
                 entries * 2 * (2 * dq + 2 * dv), dtype)


def xent_bound(T, d, V, dtype):
    """x, W and the labels read once, ce, z_loss and lse written; the
    logits' 2 T d V operations at the inputs' type's peak rate."""
    it = torch.tensor([], dtype=dtype).element_size()
    return bound(it * (T * d + d * V) + 4 * T + 12 * T, 2.0 * T * d * V,
                 dtype)


def xent_bwd_bound(T, d, V, dtype):
    """The backward's inputs (x, W, the labels, lse and the two incoming
    gradients) read once and dx, dw written once; three 2 T d V products
    (the logits, dx, dw) at the inputs' type's peak rate.  The bf16 dl that
    the port writes between them is not the function's to move."""
    it = torch.tensor([], dtype=dtype).element_size()
    return bound(it * 2 * (T * d + d * V) + 4 * T + 12 * T, 6.0 * T * d * V,
                 dtype)


def xent_dlogits_bound(T, d, V, dtype):
    """The dlogits kernel alone: x, W, labels, lse, coef and g_ce read, the
    bf16 [hi; lo] dl (2 T, V) written; the logits' 2 T d V operations."""
    it = torch.tensor([], dtype=dtype).element_size()
    return bound(it * (T * d + d * V) + 16 * T + 2 * 2 * T * V,
                 2.0 * T * d * V, dtype)


def xent_grads(T, dev, seed):
    """Incoming gradients of ce and z_loss, U(0.5, 1.5) per row: of the
    order of dl's own terms, where the bf16 gate is tightest (a mean loss
    gives 1 / T, which the gate's absolute term would swallow)."""
    gen = torch.Generator(device=dev).manual_seed(500 + seed)
    return tuple(torch.rand(T, generator=gen, device=dev) + 0.5
                 for _ in range(2))


def xent_bwd_case(x, w, labels, lse, gce, gzl, zlw=1e-4):
    """The bf16 backward (``softmax_xent_bwd_cuda``) against the plain
    backward's float32 result on the same values and ``lse``: dx and dw
    each within one bf16 step (``_bf16_close``); dw in w's layout."""
    from repro_torch.kernels import softmax_xent as xe
    dx, dw = xe.softmax_xent_bwd_cuda(x, w, labels, lse, gce, gzl, zlw)
    rdx, rdw = xe.softmax_xent_bwd(x.float(), w.float(), labels, lse, gce,
                                   gzl, zlw)
    torch.cuda.synchronize()
    out = {"dw_in_w_layout": dw.stride() == w.stride() or 1 in w.shape}
    for key, got, want in (("dx", dx, rdx), ("dw", dw, rdw)):
        ok, err, ratio = _bf16_close(got, want)
        out.update({f"{key}_ok": ok, f"{key}_max_abs_err": err,
                    f"{key}_err_over_bound": ratio})
    out["dw_ok"] = out["dw_ok"] and out["dw_in_w_layout"]
    return out


def xent_dlogits_ms(x, w, labels, lse, gce, gzl, zlw, iters):
    """Device ms of the dlogits kernel alone (the backward's one launch a
    chunk, without its products) on these inputs, one chunk of all rows."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import softmax_xent as xe
    lib = _build.load("softmax_xent")
    fn = lib.softmax_xent_dlogits_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    T, d = x.shape
    V = w.shape[1]
    vd = xe._layout(w)
    nsplit, per = xe._plan(lib, 1, T, V, vd, x.device)
    coef = (gce + 2.0 * zlw * lse * gzl).contiguous()
    dl = torch.empty((2 * T, V), dtype=torch.bfloat16, device=x.device)

    def run():
        rc = fn(x.data_ptr(), w.data_ptr(), labels.data_ptr(),
                lse.data_ptr(), coef.data_ptr(), gce.data_ptr(),
                dl.data_ptr(), T, d, V, vd, nsplit, per,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"dlogits launch failed: cudaError {rc}")
    return device_ms(run, iters)


def _rmsnorm_bwd_case(x, w, g, dtype, kernel, plain, tol):
    """dx as ``_kernel_case`` holds an output; dw, a float32 sum over every
    row, within ``tol`` of its largest entry (which grows with the rows)."""
    (dx, dw), (rdx, rdw) = kernel(x, w, g), plain(x, w, g)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        dx_err = float((dx - rdx).abs().max())
        ok = dx_err <= tol
    else:
        ok, dx_err, _ = _bf16_close(dx, rdx)
    dw_err = float((dw - rdw).abs().max())
    ok = ok and dw_err <= tol * max(1.0, float(rdw.abs().max()))
    return ok, max(dx_err, dw_err)


def _xent_inputs(T, d, V, tied, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn((V, d) if tied else (d, V), generator=gen, device=dev)
         * 0.05).to(dtype)
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    return x, (w.T if tied else w), labels


def train_kernel_checks(dev):
    """``rmsnorm_bwd_cuda``, the flash-attention dq and dkv passes and
    ``softmax_xent_cuda`` against their plain versions in float32
    (OP_TABLE's bounds; a dw summed over R rows to 2e-5 sqrt(R)) and
    bfloat16 (one rounding step of a bfloat16 output): causal and not, MHA,
    GQA and MQA, head dims 128 and 256, dq != dv, a ragged S, T and V, the
    xent weight in both layouts; then times at gemma-2b's training shapes in
    bfloat16 beside the library yardsticks (SDPA's backward for dq/dkv)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import softmax_xent as xe
    from repro_torch.kernels.ops import BACKWARD, SPECS
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_bwd_ref

    results, timing = [], {}

    def record(name, shape, dtype, ok, err, **extra):
        results.append({"name": name, "shape": list(shape),
                        "dtype": str(dtype), "max_abs_err": err,
                        "within_bound": ok, **extra})
        check(ok, f"{name} kernel disagrees at {shape} {dtype}: {err}")

    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(RMS_BWD_SHAPES):
            gen = torch.Generator().manual_seed(200 + seed)
            x, g = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                    for _ in range(2))
            w = (torch.rand(shape[-1], generator=gen) + 0.5).to(dev)
            rows = math.prod(shape[:-1])
            ok, err = _rmsnorm_bwd_case(x, w, g, dtype, rmsnorm_bwd_cuda,
                                        rmsnorm_bwd_ref,
                                        BACKWARD["rmsnorm_bwd"].tol)
            record("rmsnorm_bwd", shape, dtype, ok, err)
            if dtype == torch.bfloat16 and shape == RMS_BWD_MAIN:
                t = timings(lambda: rmsnorm_bwd_cuda(x, w, g),
                            lambda: rmsnorm_bwd_ref(x, w, g), 50)
                t["library_ms"] = backward_device_ms(
                    lambda a, b: F.rms_norm(a, (shape[-1],), b, 1e-6),
                    (x.detach().requires_grad_(),
                     w.to(dtype).requires_grad_()), g, 50)
                timing["rmsnorm_bwd"] = (t, rmsnorm_bwd_bound(
                    rows, shape[-1], dtype), err)
        for seed, case in enumerate(ATTN_BWD_SHAPES):
            B, S, H, K, dq, dv, causal = case
            gen = torch.Generator().manual_seed(300 + seed)
            q, k, v, do = (torch.randn(s, generator=gen).to(dtype).to(dev)
                           for s in ((B, S, H, dq), (B, S, K, dq),
                                     (B, S, K, dv), (B, S, H, dv)))
            o, lse = (t.contiguous() for t in
                      fl.flash_attention_ref(q, k, v, causal=causal))
            delta = fl.flash_attention_dq_ref(q, k, v, o, lse, do,
                                              causal)[1].contiguous()
            tol = BACKWARD["attention_dq"].tol
            dq_kernel = lambda: fl.flash_attention_dq_cuda(  # noqa: E731
                q, k, v, o, lse, do, causal)
            dq_plain = lambda: fl.flash_attention_dq_ref(  # noqa: E731
                q, k, v, o, lse, do, causal)
            dkv_kernel = lambda: fl.flash_attention_dkv_cuda(  # noqa: E731
                q, k, v, lse, delta, do, causal)
            dkv_plain = lambda: fl.flash_attention_dkv_ref(  # noqa: E731
                q, k, v, lse, delta, do, causal)
            ok, err = _kernel_case(dq_kernel, dq_plain, dtype, tol)
            record("attention_dq", [B, S, H, K, dq, dv], dtype, ok, err,
                   causal=causal)
            ok, err_kv = _kernel_case(dkv_kernel, dkv_plain, dtype, tol)
            record("attention_dkv", [B, S, H, K, dq, dv], dtype, ok, err_kv,
                   causal=causal)
            if dtype == torch.bfloat16 and case == ATTN_BWD_MAIN:
                lib = sdpa_backward_ms(q, k, v, do, causal)
                for name, kern, plain, e in (
                        ("attention_dq", dq_kernel, dq_plain, err),
                        ("attention_dkv", dkv_kernel, dkv_plain, err_kv)):
                    t = timings(kern, plain, 5)
                    t.update(lib)
                    timing[name] = (t, attention_bwd_bound(
                        *case, dtype, name[len("attention_"):]), e)
        for seed, (T, d, V, tied) in enumerate(XENT_SHAPES):
            x, w, labels = _xent_inputs(T, d, V, tied, dtype, 400 + seed,
                                        dev)
            ok, err = _kernel_case(
                lambda: xe.softmax_xent_cuda(x, w, labels, 1e-4),
                lambda: xe.softmax_xent_ref(x, w, labels, 1e-4), dtype,
                SPECS["softmax_xent"].tol)
            layout = "(V, d) transposed" if tied else "(d, V)"
            record("softmax_xent", [T, d, V], dtype, ok, err, layout=layout)
            if dtype == torch.bfloat16:
                lse = xe.softmax_xent_ref(x, w, labels, 1e-4)[2]
                gce, gzl = xent_grads(T, dev, seed)
                case = xent_bwd_case(x, w, labels, lse, gce, gzl)
                record("softmax_xent_bwd", [T, d, V], dtype,
                       case["dx_ok"] and case["dw_ok"],
                       max(case["dx_max_abs_err"], case["dw_max_abs_err"]),
                       layout=layout, **case)
            if dtype == torch.bfloat16 and (T, d, V, tied) == XENT_MAIN:
                t = timings(lambda: xe.softmax_xent_cuda(x, w, labels, 1e-4),
                            lambda: xe.softmax_xent_ref(x, w, labels, 1e-4),
                            2)
                t["library_ms"] = None
                t["logits_matmul_ms"] = device_ms(
                    lambda: torch.matmul(x, w), 2)
                timing["softmax_xent"] = (t, xent_bound(T, d, V, dtype), err)
                tb = timings(
                    lambda: xe.softmax_xent_bwd_cuda(x, w, labels, lse, gce,
                                                     gzl, 1e-4),
                    lambda: xe.softmax_xent_bwd(x, w, labels, lse, gce, gzl,
                                                1e-4), 1)
                tb["library_ms"] = None
                tb["logits_matmul_ms"] = t["logits_matmul_ms"]
                tb["dlogits_kernel_ms"] = xent_dlogits_ms(
                    x, w, labels, lse, gce, gzl, 1e-4, 2)
                tb["dlogits_kernel_bound_ms"] = xent_dlogits_bound(
                    T, d, V, dtype)[0]
                timing["softmax_xent_bwd"] = (
                    tb, xent_bwd_bound(T, d, V, dtype),
                    max(case["dx_max_abs_err"], case["dw_max_abs_err"]))
            del x, w, labels
    torch.cuda.empty_cache()
    return results, timing


def sdpa_backward_ms(q, k, v, do, causal):
    """The library yardstick of the two backward passes: the backward of
    ``F.scaled_dot_product_attention(enable_gqa=True)``, which computes dq,
    dk and dv in one call (device time, as the kernels beside it)."""
    import torch.nn.functional as F
    leaves = tuple(a.transpose(1, 2).detach().requires_grad_()
                   for a in (q, k, v))
    return {"library_ms": backward_device_ms(
        lambda qt, kt, vt: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True),
        leaves, do.transpose(1, 2), 5)}


def run_train(dev):
    """The full gemma-2b (18 layers, bf16, params drawn on the card from
    seed 0, ``LM(cfg, remat="full")``): ``make_train_state`` and
    ``make_train_step`` (MAP loss with the handler-scored log-prior, 2
    microbatches, clip, AdamW) for TRAIN_STEPS steps on one fixed batch of
    ``SyntheticLMData``, the launch counters set to 0 before and read
    after; then a profiled step, and ``launch.train.main`` for 2 steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM, count_params

    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg, remat="full")
    hp = steps_mod.TrainHParams(learning_rate=TRAIN_LR,
                                warmup_steps=TRAIN_WARMUP,
                                num_microbatches=TRAIN_MICROBATCHES)
    reset_peak(dev)
    t0 = time.perf_counter()
    state = steps_mod.make_train_state(
        lm, hp, rng=torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                            seed=0).batch_at(0, device=dev)
    step = steps_mod.make_train_step(lm, hp, total_tokens=tokens)

    history, step_s = [], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        history.append({k: float(v) for k, v in m.items()})
    counts = ops.launch_counts()
    n_steps = state["step"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # every step after the first (which allocates the optimizer's moments
    # and the allocator's pools)
    ms = 1e3 * float(np.median(step_s[1:]))
    L = cfg.num_layers
    per_mb = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
              "attention": 2 * L, "attention_dq": L, "attention_dkv": L,
              "softmax_xent": 1, "softmax_xent_bwd": 1}
    expected = {k: v * TRAIN_MICROBATCHES * TRAIN_STEPS
                for k, v in per_mb.items()}
    out = {"arch": cfg.name, "params": count_params(cfg),
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "microbatches": TRAIN_MICROBATCHES, "steps": n_steps,
           "init_seconds": init_s, "step_seconds": step_s,
           "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
           "history": history, "launches": counts,
           "launches_per_step": {k: counts[k] / TRAIN_STEPS
                                 for k in expected},
           "peak_mem_gb": peak_gb}
    print("gemma-2b training:", json.dumps(out), flush=True)
    check(all(math.isfinite(h[k]) for h in history
              for k in ("loss", "ce", "z_loss", "log_prior", "grad_norm")),
          "a training loss, metric or grad norm is not finite")
    check(history[-1]["ce"] < history[0]["ce"]
          and history[-1]["loss"] < history[0]["loss"],
          f"the loss did not fall over {TRAIN_STEPS} steps on a fixed batch: "
          f"ce {history[0]['ce']} -> {history[-1]['ce']}, MAP loss "
          f"{history[0]['loss']} -> {history[-1]['loss']}")
    check(n_steps == TRAIN_STEPS, f"state['step'] is {n_steps}")
    check(all(counts[k] == v for k, v in expected.items()),
          f"{TRAIN_STEPS} training steps launched {counts}, not {expected}")

    out["profile"] = device_profile(lambda: step(state, batch), 1)
    print("gemma-2b training profile:", json.dumps(out["profile"]),
          flush=True)
    del state, step, batch
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lstate, lhist = train_mod.main([
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_LAUNCHER_STEPS),
        "--seq-len", str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
        "--microbatches", str(TRAIN_MICROBATCHES), "--log-every", "1"])
    out["launcher"] = {"seconds": time.perf_counter() - t0,
                       "steps": lstate["step"], "history": lhist,
                       "launches": ops.launch_counts()}
    print("train launcher:", json.dumps(out["launcher"]), flush=True)
    check(lstate["step"] == TRAIN_LAUNCHER_STEPS
          and all(math.isfinite(h["loss"]) for h in lhist),
          f"the launcher ran {lstate['step']} steps: {lhist}")
    del lstate
    torch.cuda.empty_cache()
    return out


def run_train_f32_check(dev):
    """A full-width, TRAIN_F32_LAYERS-layer float32 gemma (params from seed 0
    on the card, remat "full"): the loss and every gradient leaf of one
    microbatch through the kernels, and again through the plain versions on
    the card (``ops.SPECS`` and ``ops.BACKWARD`` pointed at them).  In
    float32 the two differ by the kernels' own rounding: the bound is
    TRAIN_F32_REL_TOL of the largest |grad| (of |loss| for the loss)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.optim import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=TRAIN_F32_LAYERS, dtype="float32")
    lm = LM(cfg, remat="full")
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    batch = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ,
                            TRAIN_BATCH // TRAIN_MICROBATCHES,
                            seed=0).batch_at(0, device=dev)

    def loss_and_grads():
        wg = tree_map(lambda p: p.detach().requires_grad_(), w)
        loss, _ = lm.forward(wg, batch)
        grads = torch.autograd.grad(loss, tree_leaves(wg))
        return loss.detach(), grads

    ops.reset_launch_counts()
    got_loss, got = loss_and_grads()
    counts = ops.launch_counts()
    saved, saved_bwd = dict(ops.SPECS), dict(ops.BACKWARD)
    try:
        for name in ("rmsnorm", "attention", "softmax_xent"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        for name in ("rmsnorm_bwd", "attention_dq", "attention_dkv"):
            ops.BACKWARD[name] = saved_bwd[name]._replace(
                kernel=saved_bwd[name].ref)
        want_loss, want = loss_and_grads()
    finally:
        ops.SPECS.update(saved)
        ops.BACKWARD.update(saved_bwd)
    torch.cuda.synchronize()
    max_grad = max(float(g.abs().max()) for g in want)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    tol = TRAIN_F32_REL_TOL * max_grad
    loss_err = float((got_loss - want_loss).abs())
    loss_tol = TRAIN_F32_REL_TOL * max(1.0, float(want_loss.abs()))
    L = TRAIN_F32_LAYERS
    # a float32 loss takes the plain backward on every device
    expected = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
                "attention": 2 * L, "attention_dq": L, "attention_dkv": L,
                "softmax_xent": 1, "softmax_xent_bwd": 0}
    out = {"layers": L, "dtype": "float32", "loss": float(want_loss),
           "loss_abs_err": loss_err, "loss_tol": loss_tol,
           "grad_max_abs_err": err, "max_abs_grad": max_grad, "grad_tol": tol,
           "grad_leaves": len(got), "launches": counts}
    print("gemma 2-layer float32 training kernels vs plain:", json.dumps(out),
          flush=True)
    check(math.isfinite(float(got_loss))
          and all(bool(torch.isfinite(g).all()) for g in got),
          "a float32 loss or gradient is not finite")
    check(loss_err <= loss_tol, f"float32 loss through the kernels differs "
                                f"by {loss_err} > {loss_tol}")
    check(err <= tol, f"float32 gradients through the kernels differ from "
                      f"the plain versions by {err} > {tol}")
    check(all(counts[k] == v for k, v in expected.items()),
          f"the 2-layer float32 step launched {counts}, not {expected}")
    del want
    torch.cuda.empty_cache()
    out["mesh (1, 1)"] = train_mesh_check(dev, lm, w, batch, got_loss, got,
                                          counts)
    return out


def train_mesh_check(dev, lm, w, batch, loss, grads, counts):
    """The 2-layer float32 gemma on a one-rank (1, 1) LM mesh: the loss and
    every gradient leaf (against ``loss``/``grads``, the unsharded kernel
    run's, whose launches were ``counts``), then one ``make_train_step``
    step against the unsharded one from the same seed; bit for bit, the
    same launches."""
    import torch.distributed as tdist

    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import sharding_ctx
    from repro_torch.optim import tree_leaves, tree_map

    t0 = time.perf_counter()
    backend = start_one_rank_group()
    mesh = make_host_mesh((1, 1))
    rules = sharding.make_rules(lm.cfg, mesh)
    bs = sharding.batch_sharding(rules, mesh)
    placed = {k: sharding.place(v, mesh, bs.placements)
              for k, v in batch.items()}
    hp = steps_mod.TrainHParams(learning_rate=TRAIN_LR,
                                warmup_steps=TRAIN_WARMUP)
    tokens = batch["tokens"].numel()

    def state():
        return steps_mod.make_train_state(
            lm, hp, rng=torch.Generator(device=dev).manual_seed(0),
            device=dev)

    shapes, specs = lm.abstract_params()
    shardings = sharding.param_shardings(specs, rules, mesh, shapes=shapes)
    with sharding_ctx(mesh, rules):
        wd = tree_map(lambda p, s: sharding.place(
            p.detach(), mesh, s.placements).requires_grad_(), w, shardings)
        ops.reset_launch_counts()
        mloss, _ = lm.forward(wd, placed)
        mgrads = torch.autograd.grad(mloss, tree_leaves(wd))
        grad_counts = ops.launch_counts()
    grad_bits = same_bits(mloss.to_local().detach(), loss) and all(
        same_bits(a.to_local(), b) for a, b in zip(mgrads, grads))
    grad_err = max(float((a.to_local() - b).abs().max())
                   for a, b in zip(mgrads, grads))
    del wd, mgrads
    plain = state()
    step = steps_mod.make_train_step(lm, hp, total_tokens=tokens)
    ops.reset_launch_counts()
    plain, m = step(plain, batch)
    step_counts = ops.launch_counts()
    with sharding_ctx(mesh, rules):
        meshed = state()
        mstep = steps_mod.make_train_step(lm, hp, total_tokens=tokens)
        ops.reset_launch_counts()
        meshed, mm = mstep(meshed, placed)
        mesh_counts = ops.launch_counts()
    torch.cuda.synchronize()
    param_bits = all(same_bits(a, b.to_local()) for a, b in zip(
        tree_leaves(plain["params"]), tree_leaves(meshed["params"])))
    param_err = max(float((a - b.to_local()).abs().max()) for a, b in zip(
        tree_leaves(plain["params"]), tree_leaves(meshed["params"])))
    metric_bits = all(same_bits(m[k], mm[k]) for k in m)
    placements = {str(p.placements) for p in tree_leaves(meshed["params"])}
    del plain, meshed
    tdist.destroy_process_group()
    out = {"backend": backend, "loss_and_grads_bit_identical": grad_bits,
           "grad_max_abs_err": grad_err,
           "step_metrics_bit_identical": metric_bits,
           "step_params_bit_identical": param_bits,
           "step_param_max_abs_err": param_err,
           "loss": float(mm["loss"]), "placements": sorted(placements),
           "launches": {what: {k: v for k, v in c.items() if v}
                        for what, c in (("loss_and_grads", grad_counts),
                                        ("step", mesh_counts),
                                        ("unsharded step", step_counts))},
           "seconds": time.perf_counter() - t0}
    print("gemma 2-layer float32 on a (1, 1) LM mesh vs unsharded:",
          json.dumps(out), flush=True)
    check(grad_bits, f"the (1, 1) mesh's loss and gradients are not the "
                     f"unsharded kernel run's bits (max err {grad_err})")
    check(metric_bits and param_bits,
          f"the (1, 1) mesh's train step is not the unsharded step's bits "
          f"(params max err {param_err})")
    check(grad_counts == counts and mesh_counts == step_counts,
          f"the (1, 1) mesh launched {grad_counts} / {mesh_counts}, "
          f"unsharded {counts} / {step_counts}")
    return out


def train_kernel_rows(timing, checks, train):
    """The kernel-table rows of the training slice's five kernels: times
    and bounds at gemma-2b's shapes, and the launches of the 8-step run."""
    from repro_torch.kernels.ops import BACKWARD, SPECS
    rows = []
    libraries = {"rmsnorm_bwd": "backward of torch.nn.functional.rms_norm:"
                 " dx and dw in one call",
                 "attention_dq": "backward of torch.nn.functional."
                 "scaled_dot_product_attention(enable_gqa=True): dq, dk and "
                 "dv in one call",
                 "softmax_xent": None, "softmax_xent_bwd": None}
    libraries["attention_dkv"] = libraries["attention_dq"]
    notes = {"softmax_xent_bwd": "the backward of softmax_xent in bf16: the "
             "dlogits kernel, then dx and dw as bf16 products with float32 "
             "outputs (cuBLAS); the JAX package has no TPU kernel for it, "
             "its _bwd (softmax_xent.py:93) is jax.grad of ref.softmax_xent"}
    standard = ("ms", "plain_ms", "call_ms", "plain_call_ms", "library_ms")
    for name, source, shape in (
            ("rmsnorm_bwd", "rmsnorm.cu", RMS_BWD_MAIN),
            ("attention_dq", "flash_attention_bwd.cu", ATTN_BWD_MAIN),
            ("attention_dkv", "flash_attention_bwd.cu", ATTN_BWD_MAIN),
            ("softmax_xent", "softmax_xent.cu", XENT_MAIN),
            ("softmax_xent_bwd", "softmax_xent.cu", XENT_MAIN)):
        times, (bound_ms, bound_by), err = timing[name]
        spec = SPECS[name] if name in SPECS else BACKWARD[name]
        rows.append({
            "name": name, "route": spec.route,
            "source": "src/repro_torch/csrc/" + source,
            "replaces": spec.replaces,
            "launches": train["launches"][name],
            "launches_per_step": train["launches_per_step"][name],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"], "library": libraries[name],
            **{k: v for k, v in times.items() if k not in standard},
            **({"note": notes[name]} if name in notes else {}),
            "shape": list(shape), "dtype": "bfloat16"})
    return rows


# ---------------------------------------------------------------------------
# the Mamba-2 slice: mamba2-370m prefill (ssd_scan) and O(1) decode
# ---------------------------------------------------------------------------

def ssd_work(b, l, h, p, g, n, chunk, dtype):
    """(bytes, operations) of one scan: x, B, C and dt read once, y and the
    float32 state written once; the multiply-adds this run's chunks need:
    the causal scores C Bᵀ (c (c + 1) / 2 per chunk, each n long) once per
    B/C group, their product with x under each head's decay (p long), and
    each head's entering state's part and state update (c p n each)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * l * h * p + 2 * b * l * g * n) \
        + 4 * (b * l * h + 2 * h + b * h * p * n)
    nc, tri = l // chunk, chunk * (chunk + 1) // 2
    macs = b * g * nc * tri * n + b * h * nc * (tri * p + 2 * chunk * p * n)
    return nbytes, 2 * macs


def ssd_bound(b, l, h, p, g, n, chunk, dtype):
    """The scan's bound at the peak rate of the inputs' type (bf16 tensor
    cores for bf16)."""
    return bound(*ssd_work(b, l, h, p, g, n, chunk, dtype), dtype)


def ssm_serving_bounds(cfg, w, cache, batch, length):
    """The least time of the mamba2 serving phases on this run's tensors.
    Prefill of ``batch`` x ``length`` tokens: the in- and out-projections'
    products over every token, the unembedding at the last position and
    every layer's scan (``ssd_work``) at the bf16 rate, beside every weight
    read once.  Decode step: every weight but the embedding table (of which
    it reads ``batch`` rows) read once, the state and conv caches read and
    written once."""
    from repro_torch.models.ssm import N_GROUPS

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()
    mixer = w["layers"]["p0"]["mixer"]
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    d_in, h, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    tokens = batch * length
    products = 2 * tokens * (mixer["w_in"].numel() + mixer["w_out"].numel()) \
        + 2 * batch * d * V
    _, scan = ssd_work(batch, length, h, d_in // h, N_GROUPS, n,
                       min(cfg.ssm_chunk, length), cfg.torch_dtype)
    weights = nbytes(w)
    prefill = bound(weights, products + L * scan, cfg.torch_dtype)
    decode_bytes = weights - nbytes(w["embed"]) + 2 * nbytes(cache)
    decode = bound(decode_bytes, 0, cfg.torch_dtype)
    return {"prefill_bound_ms": prefill[0], "prefill_bound_by": prefill[1],
            "prefill_flops": products + L * scan, "prefill_scan_flops": L * scan,
            "decode_bound_ms": decode[0], "decode_bound_by": decode[1],
            "decode_bytes": decode_bytes, "weight_bytes": weights,
            "cache_bytes": nbytes(cache)}


def _ssd_inputs(b, l, h, p, g, n, dtype, dev, seed):
    """Inputs in mamba2's ranges: dt in [1e-3, 0.1], A in [-16, -1], x, B
    and C in ``dtype``, the rest float32."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    x = (0.5 * randn(b, l, h, p)).to(dtype)
    dt = 1e-3 + (0.1 - 1e-3) * rand(b, l, h)
    A = -(1.0 + 15.0 * rand(h))
    B = (0.3 * randn(b, l, g, n)).to(dtype)
    C = (0.3 * randn(b, l, g, n)).to(dtype)
    return x, dt, A, B, C, 0.5 + rand(h), 0.1 * randn(b, h, p, n)


def ssm_kernel_checks(dev):
    """``ssd_scan_cuda`` against ``ssd_scan_ref`` on the card: float32 y
    and state within OP_TABLE's 1e-4; bfloat16 y within one rounding step
    and the float32 state within 1e-4 of its largest entry; without D, with
    D, with D and h0, on SSD_SHAPES; a ragged length raises; ``SsdScan``
    launches the kernel once forward and its gradients equal autograd of
    ``ssd_scan_ref`` (float32, within 1e-4 of each gradient's largest
    entry); then times at the main
    shape in bfloat16.  No single PyTorch call computes the scan."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    tol = ops.SPECS["ssd_scan"].tol
    results, timing = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for seed, shape in enumerate(SSD_SHAPES):
            b, l, h, p, g, n, chunk = shape
            x, dt, A, B, C, D, h0 = _ssd_inputs(b, l, h, p, g, n, dtype, dev,
                                                seed)
            for label, kw in (("", {}), ("D", {"D": D}),
                              ("D,h0", {"D": D, "h0": h0})):
                y, st = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, **kw)
                ry, rst = ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk, **kw)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    y_err = float((y - ry).abs().max())
                    y_ok = y_err <= tol
                else:
                    y_ok, y_err, _ = _bf16_close(y, ry)
                st_err = float((st - rst).abs().max())
                st_tol = tol * (1.0 if dtype == torch.float32
                                else max(1.0, float(rst.abs().max())))
                ok = y_ok and st_err <= st_tol and bool(
                    torch.isfinite(y).all() and torch.isfinite(st).all())
                results.append({"name": "ssd_scan", "shape": list(shape),
                                "dtype": str(dtype), "operands": label,
                                "max_abs_err": max(y_err, st_err),
                                "y_max_abs_err": y_err,
                                "state_max_abs_err": st_err,
                                "state_tol": st_tol, "within_bound": ok})
                check(ok, f"ssd_scan kernel disagrees at {shape} {dtype} "
                          f"[{label}]: y {y_err}, state {st_err}")
                if label == "D":
                    main_err = y_err
            if dtype == torch.bfloat16 and shape == SSD_MAIN:
                t = timings(
                    lambda: ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                              D=D),
                    lambda: ssd.ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                             D=D), 5)
                t["library_ms"] = None
                # the rate on the operations the function needs (C B^T
                # once per group), not on the kernel's own HMMA work
                t["work_flops"] = ssd_work(*shape, dtype)[1]
                t["achieved_tflops"] = t["work_flops"] / t["ms"] / 1e9
                timing["ssd_scan"] = (t, ssd_bound(*shape, dtype), main_err)
        b, l, h, p, g, n, chunk = SSD_SHAPES[-1]
        try:
            ssd.ssd_scan_cuda(x[:, :l - 1], dt[:, :l - 1], A, B[:, :l - 1],
                              C[:, :l - 1], chunk=chunk)
            raised = False
        except ValueError:
            raised = True
        check(raised, "ssd_scan_cuda took a length that is not a whole "
                      "number of chunks")

    b, l, h, p, g, n, chunk = SSD_BWD_SHAPE
    args = _ssd_inputs(b, l, h, p, g, n, torch.float32, dev, 99)
    gen = torch.Generator(device=dev).manual_seed(100)
    gy = torch.randn((b, l, h, p), generator=gen, device=dev)
    gs = torch.randn((b, h, p, n), generator=gen, device=dev)

    def grads(scan):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        y, st = scan(*leaves)
        ((y * gy).sum() + (st * gs).sum()).backward()
        return [a.grad for a in leaves]

    # the backward recomputes the plain version, so what the card can show
    # is that SsdScan runs the kernel forward (one launch) and wires the
    # plain gradient through: autograd of ssd_scan_ref called directly
    ops.reset_launch_counts()
    got = grads(lambda *a: ssd.SsdScan.apply(*a, chunk, ssd.ssd_scan_cuda))
    fwd_launches = ops.launch_counts()["ssd_scan"]
    want = grads(lambda x, dt, A, B, C, D, h0: ssd.ssd_scan_ref(
        x, dt, A, B, C, chunk=chunk, D=D, h0=h0))
    errs = [float((a - r).abs().max()) / max(1.0, float(r.abs().max()))
            for a, r in zip(got, want)]
    ok = max(errs) <= tol and fwd_launches == 1
    results.append({"name": "ssd_scan_backward", "shape": list(SSD_BWD_SHAPE),
                    "dtype": "torch.float32", "max_rel_err": max(errs),
                    "kernel_launches": fwd_launches, "within_bound": ok})
    check(ok, f"SsdScan launched the kernel {fwd_launches} times (not 1) or "
              f"its gradients differ from autograd of the plain version by "
              f"{max(errs)} of the largest gradient")
    return results, timing


def run_ssm(dev):
    """The full mamba2-370m (48 layers, bf16, params drawn on the card from
    seed 0): ``make_prefill_step`` at B = 4, P = 2048, then the launcher's
    serving loop (``serve.generate`` over a 512-token prompt, then 32
    sampled tokens), each with the launch counters set to 0 before and read
    after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import LM, count_params

    cfg = get_config(SSM_ARCH)
    lm = LM(cfg)
    reset_peak(dev)
    t0 = time.perf_counter()
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, P, V = SSM_BATCH, SSM_PREFILL_LEN, SSM_PROMPT, cfg.vocab_size
    long_prompt = _gen_tokens(V, B, S, dev)
    prompt = long_prompt[:, :P].contiguous()
    prefill = make_prefill_step(lm)

    ops.reset_launch_counts()
    long_last = prefill(w, {"tokens": long_prompt})
    torch.cuda.synchronize()
    prefill_counts = ops.launch_counts()
    t0 = time.perf_counter()
    for _ in range(SSM_PREFILL_REPS):
        prefill(w, {"tokens": long_prompt})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0) / SSM_PREFILL_REPS

    ops.reset_launch_counts()
    result = serve.generate(lm, w, prompt, SSM_TOKENS, temperature=1.0)
    serve_counts = ops.launch_counts()
    steps_run = P - 1 + SSM_TOKENS
    first, seq = result["first_logits"], result["tokens"]
    last = prefill(w, {"tokens": prompt})

    diff = (first.float() - last.float())
    rel_rms = float(diff.pow(2).mean().sqrt()
                    / last.float().pow(2).mean().sqrt())
    top1 = (first.argmax(-1) == last.argmax(-1)).float().mean()
    out = {
        "arch": cfg.name, "params": count_params(cfg), "batch": B,
        "prefill_len": S, "prompt_len": P, "new_tokens": SSM_TOKENS,
        "init_seconds": init_s, "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": B * S / (prefill_ms / 1e3),
        "prefill_launches": prefill_counts,
        "teacher_forced_ms_per_step": 1e3 * result["teacher_forced_seconds"]
        / (P - 1),
        "sampled_ms_per_token": 1e3 * result["sampled_seconds"] / SSM_TOKENS,
        "sampled_tokens_per_s": B * SSM_TOKENS / result["sampled_seconds"],
        "serve_launches": serve_counts, "serve_steps": steps_run,
        "prefill_vs_decode_logits": {
            "max_abs_err": float(diff.abs().max()), "rel_rms_err": rel_rms,
            "rel_rms_bound": LM_REL_RMS_MAX,
            "top1_agreement": float(top1),
            "logit_rms": float(last.float().pow(2).mean().sqrt())},
    }
    print("mamba2-370m serving:", json.dumps(out), flush=True)
    check(tuple(long_last.shape) == (B, V) and tuple(last.shape) == (B, V)
          and tuple(first.shape) == (B, V),
          f"logits have shapes {tuple(long_last.shape)}, "
          f"{tuple(last.shape)}, {tuple(first.shape)}")
    check(bool(torch.isfinite(long_last).all() and torch.isfinite(last).all()
               and torch.isfinite(first).all()),
          "a mamba2 prefill or decode logit is not finite")
    check(tuple(seq.shape) == (B, P + SSM_TOKENS)
          and bool(((seq >= 0) & (seq < V)).all()),
          f"tokens of shape {tuple(seq.shape)} or outside [0, {V})")
    check(torch.equal(seq[:, :P], prompt), "the prompt was not kept")
    check(rel_rms <= LM_REL_RMS_MAX,
          f"mamba2 prefill and teacher-forced decode logits at P-1 differ by "
          f"{rel_rms} (relative rms) > {LM_REL_RMS_MAX}")
    per_pass = cfg.num_layers + 1
    check(prefill_counts["ssd_scan"] == cfg.num_layers
          and prefill_counts["rmsnorm"] == per_pass,
          f"mamba2 prefill launched ssd_scan {prefill_counts['ssd_scan']} and "
          f"rmsnorm {prefill_counts['rmsnorm']} times, not {cfg.num_layers} "
          f"and {per_pass}")
    check(serve_counts["ssd_scan"] == 0
          and serve_counts["rmsnorm"] == per_pass * steps_run,
          f"mamba2 serving launched ssd_scan {serve_counts['ssd_scan']} and "
          f"rmsnorm {serve_counts['rmsnorm']} times over {steps_run} steps, "
          f"not 0 and {per_pass} per step")

    out["decode_breakdown"] = decode_breakdown(lm, w, prompt, 16)
    step = make_serve_step(lm)
    cache = lm.init_cache(B, P + SSM_TOKENS, device=dev)
    out["bounds"] = ssm_serving_bounds(cfg, w, cache, B, S)
    tok = prompt[:, :1]

    def serve_one():
        step(w, cache, tok, 0, torch.Generator().manual_seed(0))
    out["decode_breakdown"]["host_syncs_per_step"] = count_syncs(serve_one)
    out["prefill_host_syncs"] = count_syncs(
        lambda: prefill(w, {"tokens": long_prompt}))
    out["decode_profile"] = device_profile(serve_one, 8)
    out["prefill_profile"] = device_profile(
        lambda: prefill(w, {"tokens": long_prompt}), 2)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print("mamba2-370m breakdown:", json.dumps(
        {k: out[k] for k in ("decode_breakdown", "decode_profile",
                             "prefill_profile", "prefill_host_syncs",
                             "peak_mem_gb", "bounds")}), flush=True)
    return out


def run_ssm_f32_check(dev):
    """A full-width, SSM_F32_LAYERS-layer float32 mamba2 (params from seed 0
    on the card) through the kernels and through the plain versions on the
    card (``ops.SPECS`` pointed at them for the second run): the prefill's
    last logits at B = 4, P = 512, then SSM_F32_DECODE_STEPS decode steps of
    the prompt teacher-forced into a fresh cache, and that cache's state and
    conv tail.  In float32 the two differ by the kernels' own rounding: the
    bound is SSM_F32_REL_TOL of the largest logit (of the largest entry for
    a cache)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_F32_LAYERS,
                              dtype="float32")
    lm = LM(cfg)
    w = lm.init(torch.Generator(device=dev).manual_seed(0))
    prompt = _gen_tokens(cfg.vocab_size, SSM_BATCH, SSM_PROMPT, dev)
    prefill = make_prefill_step(lm)
    steps = SSM_F32_DECODE_STEPS

    def decode():
        cache = lm.init_cache(SSM_BATCH, steps, device=dev)
        logits = []
        for t in range(steps):
            lg, cache = lm.decode_step(w, prompt[:, t:t + 1], cache, t)
            logits.append(lg)
        return torch.stack(logits), cache["layers"]["p0"]["ssm"]

    ops.reset_launch_counts()
    got = prefill(w, {"tokens": prompt})
    prefill_counts = ops.launch_counts()
    ops.reset_launch_counts()
    got_dec, got_cache = decode()
    decode_counts = ops.launch_counts()
    saved = dict(ops.SPECS)
    try:
        for name in ("rmsnorm", "ssd_scan"):
            ops.SPECS[name] = saved[name]._replace(kernel=saved[name].ref)
        want = prefill(w, {"tokens": prompt})
        want_dec, want_cache = decode()
    finally:
        ops.SPECS.update(saved)
    torch.cuda.synchronize()

    def rel(a, b):
        err = float((a - b).abs().max())
        return err, SSM_F32_REL_TOL * max(1.0, float(b.abs().max()))

    err, tol = rel(got, want)
    dec_err, dec_tol = rel(got_dec, want_dec)
    cache_errs = {k: rel(got_cache[k], want_cache[k]) for k in got_cache}
    out = {"layers": SSM_F32_LAYERS, "dtype": "float32", "max_abs_err": err,
           "tol": tol, "max_abs_logit": float(want.abs().max()),
           "launches": prefill_counts, "decode_steps": steps,
           "decode_max_abs_err": dec_err, "decode_tol": dec_tol,
           "cache_max_abs_err": {k: e for k, (e, _) in cache_errs.items()},
           "cache_tol": {k: t for k, (_, t) in cache_errs.items()},
           "decode_launches": decode_counts}
    print("mamba2 2-layer float32 kernels vs plain:", json.dumps(out),
          flush=True)
    check(bool(torch.isfinite(got).all() and torch.isfinite(got_dec).all()),
          "a float32 mamba2 logit is not finite")
    check(err <= tol, f"float32 mamba2 prefill through the kernels differs "
                      f"from the plain versions by {err} > {tol}")
    check(dec_err <= dec_tol, f"float32 mamba2 decode through the kernels "
                              f"differs from the plain versions by {dec_err}"
                              f" > {dec_tol}")
    for k, (e, t) in cache_errs.items():
        check(e <= t, f"float32 mamba2 decode cache {k} differs by {e} > {t}")
    L = SSM_F32_LAYERS
    check(prefill_counts["ssd_scan"] == L
          and prefill_counts["rmsnorm"] == L + 1,
          f"{L}-layer mamba2 prefill launched {prefill_counts}")
    check(decode_counts["ssd_scan"] == 0
          and decode_counts["rmsnorm"] == (L + 1) * steps,
          f"{steps} {L}-layer mamba2 decode steps launched {decode_counts}")
    return out


def ssm_kernel_rows(checks, timing, ssm):
    """The kernel-table row of ``ssd_scan``: its time and bound at
    mamba2-370m's prefill shape, and the launches of the mamba2 serving
    phases."""
    from repro_torch.kernels.ops import SPECS
    times, (bound_ms, bound_by), err = timing["ssd_scan"]
    by_phase = {"prefill": ssm["prefill_launches"]["ssd_scan"],
                "serve": ssm["serve_launches"]["ssd_scan"]}
    return [{
        "name": "ssd_scan", "route": SPECS["ssd_scan"].route,
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": SPECS["ssd_scan"].replaces,
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        "launches_per_prefill": by_phase["prefill"],
        "launches_per_decode_step": by_phase["serve"] / ssm["serve_steps"],
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["name"] == "ssd_scan"),
        "max_abs_err_main_shape": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "call_ms": times["call_ms"], "plain_call_ms": times["plain_call_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "achieved_tflops": times["achieved_tflops"],
        "library": "none: no single PyTorch call computes the SSD scan",
        "shape": list(SSD_MAIN), "dtype": "bfloat16",
        "note": "its backward is autograd of the plain version, as the JAX "
                "package's custom_vjp differentiates its jnp reference; no "
                "TPU kernel"}]


def skim_planted_gate(lam_draws, true_pairs):
    """Are the ``2 * n_inter`` dimensions of largest posterior-median
    ``lambda`` exactly the planted ones?  Returns ``(ok, top)``."""
    planted = np.unique(np.asarray(true_pairs).ravel())
    med = np.median(np.asarray(lam_draws).reshape(-1, lam_draws.shape[-1]),
                    axis=0)
    top = np.argsort(-med, kind="stable")[:planted.size]
    return bool(set(top.tolist()) == set(planted.tolist())), top.tolist()


def run_skim(dev):
    """The third paper model: SKIM at p = 256, n = 200 under NUTS, through
    the generic autograd potential (five prior terms with their
    transforms, the kernel matrix, the library's Cholesky factor and
    triangular solve), one ``nuts_leaf`` launch a leapfrog.  Gates: finite
    draws, at most 1 % divergent, the planted dimensions the largest
    posterior-median ``lambda``, the tree's launches."""
    from repro_torch.bench.models import skim_data, skim_model
    from repro_torch.core.infer import MCMC, NUTS, effective_sample_size
    from repro_torch.kernels import ops

    data = skim_data(SKIM_P, seed=0, n=SKIM_N, n_inter=SKIM_INTER)
    reset_peak(dev)
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(skim_model, max_tree_depth=8), num_warmup=SKIM_WARMUP,
                num_samples=SKIM_DRAWS)
    mcmc.run(0, data["x"], y=data["y"])
    counts = ops.launch_counts()
    stats = mcmc.stats
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    lf = stats["num_leapfrog"]
    lam = samples["lambda"].detach().cpu().numpy()
    finite = all(bool(torch.isfinite(v).all()) for v in samples.values())
    divergences = int(extra["diverging"].sum())
    planted_ok, top = skim_planted_gate(lam, data["true_pairs"])
    out = {
        "p": SKIM_P, "n": SKIM_N, "n_inter": SKIM_INTER,
        "num_warmup": SKIM_WARMUP, "num_samples": SKIM_DRAWS,
        "setup_seconds": stats["setup_seconds"],
        "chain_seconds": stats["chain_seconds"], "num_leapfrog": lf,
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / lf,
        "num_grad_evals": stats["num_grad_evals"],
        "ms_per_grad_eval": 1e3 * stats["chain_seconds"]
        / stats["num_grad_evals"],
        "mean_num_steps": float(extra["num_steps"].float().mean()),
        "host_syncs_per_leapfrog": stats["host_syncs"] / lf,
        "launches": counts,
        "mean_accept_prob": float(extra["accept_prob"].float().mean()),
        "step_size": float(extra["step_size"][-1]),
        "divergences": divergences,
        "true_pairs": np.asarray(data["true_pairs"]).tolist(),
        "top_median_lambda": top,
        "min_ess_lambda": float(np.min(effective_sample_size(lam))),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    print("SKIM NUTS:", json.dumps(out), flush=True)
    check(finite, "a SKIM draw is not finite")
    check(divergences <= SKIM_DIVERGENT_MAX * SKIM_DRAWS,
          f"{divergences} of {SKIM_DRAWS} SKIM draws divergent")
    check(planted_ok, f"the largest posterior-median lambda are {top}, not "
          f"the planted {out['true_pairs']}")
    tree_gates(counts, stats)
    return out, counts


def run_eight_schools(dev):
    """The README's eight schools, non-centered by ``reparam`` with
    ``LocScaleReparam(0.0)``: NUTS, 4 chains in lockstep (the example's
    default ``chain_method="vectorized"``; the generic potential, a loop
    over the live chains, under the lockstep tree), gated on split R-hat <
    1.05 for every site and the lockstep tree's launches; then
    ``Predictive`` of the posterior on the card, gated on the shape and
    finiteness of ``obs``."""
    from repro_torch.bench.models import eight_schools, eight_schools_data
    from repro_torch.core.handlers import reparam
    from repro_torch.core.infer import MCMC, NUTS, Predictive, gelman_rubin
    from repro_torch.core.reparam import LocScaleReparam
    from repro_torch.kernels import ops

    data = eight_schools_data()
    model = reparam(eight_schools, config={"theta": LocScaleReparam(0.0)})
    ops.reset_launch_counts()
    mcmc = MCMC(NUTS(model), num_warmup=ES_WARMUP, num_samples=ES_DRAWS,
                num_chains=ES_CHAINS)
    mcmc.run(0, data["sigma"], y=data["y"])
    counts = ops.launch_counts()
    stats = mcmc.stats
    grouped = mcmc.get_samples(group_by_chain=True)
    rhat = {k: float(np.max(gelman_rubin(v.detach().cpu().numpy())))
            for k, v in grouped.items()}
    lf = stats["num_leapfrog"]
    t0 = time.perf_counter()
    sigma = torch.from_numpy(data["sigma"]).to(dev)
    post = Predictive(model, mcmc.get_samples())(1, sigma)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    obs = post["obs"]
    out = {
        "chains": ES_CHAINS, "num_warmup": ES_WARMUP, "num_samples": ES_DRAWS,
        "chain_method": mcmc.chain_method,
        "chain_seconds": stats["chain_seconds"], "num_leapfrog": lf,
        "ms_per_leapfrog": 1e3 * stats["chain_seconds"] / lf,
        "lockstep_leapfrogs": stats["lockstep_leapfrogs"],
        "ms_per_lockstep_leapfrog": 1e3 * stats["chain_seconds"]
        / stats["lockstep_leapfrogs"],
        "lockstep_efficiency": stats["lockstep_efficiency"],
        "host_syncs_per_leapfrog": stats["host_syncs"] / lf,
        "host_syncs_per_lockstep_leapfrog": stats["host_syncs"]
        / stats["lockstep_leapfrogs"],
        "launches": counts,
        "divergences": int(mcmc.get_extra_fields()["diverging"].sum()),
        "max_split_rhat_by_site": rhat,
        "predictive_seconds": pred_s,
        "predictive_obs_shape": list(obs.shape),
        "predictive_obs_device": str(obs.device),
        "predictive_theta_mean": post["theta"].mean(0).tolist(),
    }
    print("eight schools NUTS:", json.dumps(out), flush=True)
    check(max(rhat.values()) < ES_RHAT_MAX,
          f"max split R-hat {max(rhat.values())} >= {ES_RHAT_MAX}")
    check(tuple(obs.shape) == (ES_CHAINS * ES_DRAWS, 8)
          and obs.device.type == "cuda" and bool(torch.isfinite(obs).all()),
          f"Predictive obs has shape {tuple(obs.shape)} on {obs.device} or "
          "is not finite")
    tree_gates(counts, stats)
    return out, counts


def run_samplers(dev):
    """The kernels of slices 1-3 against their plain versions, then their
    main paths (NUTS logreg, one chain and 8 in lockstep, the two HMMs,
    SKIM, eight schools, cross-chain and dense-mass NUTS, ChEES, MALA,
    RWM); returns their
    rows of the kernel table and prints the seconds of each part."""
    part_s, t0 = {}, time.perf_counter()
    lf_checks, lf_timing, nuts_timing = leapfrog_checks(dev)
    glm_checks_, glm_timing = glm_checks(dev)
    enum_checks_, enum_timings = enum_checks(dev)
    print("nuts_leaf / nuts_turning timings:", json.dumps(
        {k: {**t, "bound_ms": b, "bound_by": by}
         for k, (t, (b, by), _) in nuts_timing.items()}), flush=True)
    print("kernel checks:", json.dumps({"leapfrog_halfstep": lf_checks,
                                        "glm_potential_grad": glm_checks_,
                                        "enum_contract": enum_checks_}),
          flush=True)
    print("glm_potential_grad timings by chains:", json.dumps(
        {str(c): {**t, "bound_ms": b, "bound_by": by}
         for c, (t, (b, by), _) in glm_timing.items()}), flush=True)
    print("enum_contract timings:", json.dumps(
        {str(shape): t for shape, t in enum_timings.items()}), flush=True)
    chain_checks_, chain_timings = chain_checks(dev)
    print("enum_chain checks:", json.dumps(chain_checks_), flush=True)
    print("enum_chain timings:", json.dumps(
        {str(shape): t for shape, t in chain_timings.items()}), flush=True)
    t_sample = time.perf_counter()
    sample_checks, sample_timings = chain_sample_checks(dev)
    part_s["enum_chain_sample checks (of kernel checks)"] = (
        time.perf_counter() - t_sample)
    print("enum_chain_sample checks:", json.dumps(sample_checks), flush=True)
    print("enum_chain_sample timings:", json.dumps(
        {str(T): t for T, t in sample_timings.items()}), flush=True)
    ens_checks, ens_timing = ensemble_kernel_checks(dev)
    print("ensemble kernel checks:", json.dumps(ens_checks), flush=True)
    print("ensemble kernel timings:", json.dumps(
        {str(k): v for k, v in ens_timing.items()}), flush=True)
    batch_checks, batch_timing = nuts_batch_checks(dev)
    print("lockstep NUTS kernel checks:", json.dumps(batch_checks),
          flush=True)
    print("lockstep NUTS kernel timings:", json.dumps(
        {k: {**t, "bound_ms": b, "bound_by": by}
         for k, (t, (b, by), _) in batch_timing.items()}), flush=True)


    def lap(name):
        nonlocal t0
        part_s[name], t0 = time.perf_counter() - t0, time.perf_counter()

    lap("kernel checks")
    from repro_torch.bench.models import covtype_data
    data = covtype_data(seed=0, n=N, d=D)
    data_s = time.perf_counter() - t0
    path, counts = run_main_path(dev, data, data_s)
    lap("NUTS logreg")
    vec, vec_counts = run_nuts_vectorized(dev, data, path["adaptive"])
    lap("vectorized NUTS logreg")
    enum_path, enum_counts, enum_draws = run_enum_hmm(dev)
    lap("enumerated HMM")
    discrete, discrete_counts = run_infer_discrete(dev, *enum_draws)
    lap("infer_discrete")
    hmm, hmm_counts = run_hmm(dev)
    lap("semi-supervised HMM")
    skim, skim_counts = run_skim(dev)
    lap("SKIM")
    schools, schools_counts = run_eight_schools(dev)
    lap("eight schools")
    xchain, xchain_counts = run_cross_chain(dev)
    lap("cross-chain NUTS")
    run_dense(dev)
    lap("dense-mass NUTS")
    print("graphed trajectory checks:", json.dumps(
        trajectory_checks(dev, data)), flush=True)
    chees, chees_counts = run_chees(dev, data)
    lap("ChEES")
    mala, mala_counts, mala_mean = run_mrw(dev, data, "MALA")
    lap("MALA")
    rwm, rwm_counts, _ = run_mrw(dev, data, "RWM",
                                 init_w=torch.from_numpy(mala_mean))
    lap("RWM")
    print("sampler part seconds:", json.dumps(part_s), flush=True)

    from repro_torch.kernels.ops import FUSED, SPECS
    kernels = []
    times, (bound_ms, bound_by), err = lf_timing
    nuts_phases = {"NUTS": (path["adaptive"], counts),
                   "enumerated HMM": (enum_path, enum_counts),
                   "semi-supervised HMM": (hmm, hmm_counts),
                   "SKIM": (skim, skim_counts),
                   "eight schools": (schools, schools_counts)}
    kernels.append({
        "name": "leapfrog_halfstep", "route": SPECS["leapfrog_halfstep"].route,
        "source": "src/repro_torch/csrc/leapfrog.cu",
        "replaces": SPECS["leapfrog_halfstep"].replaces,
        "launches": counts["leapfrog_halfstep"],
        "max_abs_err": max(c["max_abs_err"] for c in lf_checks
                           if "name" not in c),
        "max_abs_err_main_shape": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "call_ms": times["call_ms"], "plain_call_ms": times["plain_call_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "launches_per_leapfrog": counts["leapfrog_halfstep"]
        / path["adaptive"]["num_leapfrog"],
        "launches_by_phase": {p: c["leapfrog_halfstep"]
                              for p, (_, c) in nuts_phases.items()},
        "note": "inside a NUTS subtree it runs fused into nuts_leaf; on its "
                "own it opens each subtree and runs the step-size search"})
    # the NUTS leaf ops fused around row 1 (nuts_leaf runs its arithmetic)
    for name, note in (
            ("nuts_leaf", "one launch a leapfrog of a NUTS tree: the closing "
             "kick, ke, the momentum sum, a checkpoint row or the U-turn "
             "dots, the packed read and the next leapfrog's opening (row "
             "1's function); timed at an odd leaf with one checkpoint row"),
            ("nuts_turning", "the merged tree's U-turn dots, one launch a "
             "doubling the subtree did not stop (no TPU kernel: "
             "_is_turning is plain jnp in the JAX package)")):
        times, (bound_ms, bound_by), err = nuts_timing[name]
        kernels.append({
            "name": name, "route": FUSED[name].route,
            "source": "src/repro_torch/csrc/leapfrog.cu",
            "replaces": FUSED[name].replaces, "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in lf_checks
                               if c.get("name") == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launches_per_leapfrog": counts[name]
            / path["adaptive"]["num_leapfrog"],
            "launches_by_phase": {p: c[name]
                                  for p, (_, c) in nuts_phases.items()},
            "launches_per_leapfrog_by_phase": {
                p: c[name] / o["num_leapfrog"]
                for p, (o, c) in nuts_phases.items()},
            "shape": [D], "note": note})
    # the GLM row: the NUTS path's C = 1 as its main numbers, C = 8 and 16
    # (ChEES's and MALA/RWM's) beside them
    name = "glm_potential_grad"
    times, (bound_ms, bound_by), err = glm_timing[1]
    phases = {"NUTS": (path["adaptive"], counts), "ChEES": (chees,
                                                             chees_counts),
              "MALA": (mala, mala_counts), "RWM": (rwm, rwm_counts)}
    kernels.append({
        "name": name, "kernel": "glm_chains_kernel",
        "route": SPECS[name].route,
        "source": "src/repro_torch/csrc/glm_potential.cu",
        "replaces": SPECS[name].replaces, "launches": counts[name],
        "launches_by_phase": {p: c[name] for p, (_, c) in phases.items()},
        "chain_evals_by_phase": {p: o["glm_chain_evals"]
                                 for p, (o, _) in phases.items()
                                 if p != "NUTS"},
        "launches_per_ensemble_eval": {
            p: o["glm_launches_per_ensemble_eval"]
            for p, (o, _) in phases.items() if p != "NUTS"},
        "max_abs_err": max(c["max_abs_err"] for c in glm_checks_),
        "max_abs_err_main_shape": err,
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "call_ms": times["call_ms"], "plain_call_ms": times["plain_call_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "launches_per_leapfrog": counts[name]
        / path["adaptive"]["num_leapfrog"],
        "by_chains": {str(c): {"ms": t["ms"], "plain_ms": t["plain_ms"],
                               "call_ms": t["call_ms"],
                               "plain_call_ms": t["plain_call_ms"],
                               "bound_ms": b, "bound_by": by}
                      for c, (t, (b, by), _) in glm_timing.items()},
        "shape": [N, D], "chains": list(GLM_CHAINS)})
    # the chain-batched NUTS ops (lockstep NUTS: the vmap of rows 1 and 1b)
    lockstep_phases = {"vectorized NUTS": (vec, vec_counts),
                       "eight schools": (schools, schools_counts),
                       "cross-chain NUTS": (xchain, xchain_counts)}
    for name, note in (
            ("nuts_leaf_batch", "one launch a lockstep leapfrog of C "
             "chains' NUTS trees, each chain its own step size, m_inv row, "
             "checkpoints and active flag (the JAX package's vmap of row "
             "1's leaf); timed at C = 8 every chain active, an odd leaf "
             "with one checkpoint row"),
            ("nuts_turning_batch", "the C merged trees' U-turn dots, one "
             "launch a lockstep doubling (the vmap of row 1b)"),
            ("halfstep_chains", "row 1's half-step with a signed step size, "
             "m_inv row and active flag per chain: opens each lockstep "
             "subtree")):
        times, (bound_ms, bound_by), err = batch_timing[name]
        kernels.append({
            "name": name, "route": FUSED[name].route,
            "source": "src/repro_torch/csrc/leapfrog.cu",
            "replaces": FUSED[name].replaces, "launches": vec_counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in batch_checks
                               if c["name"] == name),
            "max_abs_err_main_shape": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "launches_per_lockstep_leapfrog": vec_counts[name]
            / vec["lockstep_leapfrogs"],
            "launches_by_phase": {p: c[name]
                                  for p, (_, c) in lockstep_phases.items()},
            "shape": [VEC_CHAINS, D], "note": note})
    main_t, large_t = enum_timings[ENUM_MAIN], enum_timings[ENUM_LARGE]
    off_path = ("no main path launches it: markov runs the T-1 steps "
                "through enum_chain; checked and timed as the port of the "
                "TPU kernel")
    for name, replaces, err_key, note in (
            ("enum_contract", SPECS["enum_contract"].replaces,
             "max_abs_err", off_path),
            ("enum_contract_bwd", None, "bwd_max_abs_err",
             "the backward of enum_contract: the JAX package has no TPU "
             "kernel for it, it differentiates ref.enum_contract; "
             + off_path)):
        times, (bound_ms, bound_by) = main_t[name]
        ltimes, (lbound_ms, lbound_by) = large_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/enum_contract.cu",
            "replaces": replaces, "launches": enum_counts[name],
            "max_abs_err": max(c[err_key] for c in enum_checks_),
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"],
            "launches_per_leapfrog": enum_counts[name]
            / enum_path["num_leapfrog"],
            "shape": main_t["shape"],
            "large": {"shape": large_t["shape"], "ms": ltimes["ms"],
                      "plain_ms": ltimes["plain_ms"],
                      "call_ms": ltimes["call_ms"],
                      "library_ms": ltimes["library_ms"],
                      "bound_ms": lbound_ms, "bound_by": lbound_by},
            "note": note})
    main_t, large_t = chain_timings[CHAIN_MAIN], chain_timings[CHAIN_LARGE]
    for name, replaces, note in (
            ("enum_chain", FUSED["enum_chain"].replaces,
             "the T-1 enum_contract steps of markov's lax.scan in one "
             "launch (no TPU kernel of its own: the JAX package scans row "
             "5's kernel)"),
            ("enum_chain_bwd", None,
             "the backward of enum_chain, T-1 steps in one launch; "
             "max_abs_err against the plain chain backward, within (T-1) x "
             "1e-6 of each output's largest entry")):
        times, (bound_ms, bound_by) = main_t[name]
        ltimes, (lbound_ms, lbound_by) = large_t[name]
        err_key = "max_abs_err" if name == "enum_chain" else \
            "bwd_max_abs_err"
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/enum_contract.cu",
            "replaces": replaces, "launches": enum_counts[name],
            "max_abs_err": max(c[err_key] for c in chain_checks_),
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "call_ms": times["call_ms"],
            "plain_call_ms": times["plain_call_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times["library_ms"],
            "ns_per_step": times["ns_per_step"],
            "one_step_launches_ms": times["one_step_launches_ms"],
            "launches_per_leapfrog": enum_counts[name]
            / enum_path["num_leapfrog"],
            "launches_per_grad_eval": enum_counts[name]
            / enum_path["num_grad_evals"],
            # sample mode's forward filter (enum_chain_alphas): one launch
            # an infer_discrete call of the enumerated HMM
            "launches_by_phase": {
                "enumerated HMM": enum_counts[name],
                "infer_discrete": discrete_counts[name]},
            "shape": main_t["shape"],
            "large": {"shape": large_t["shape"], "ms": ltimes["ms"],
                      "plain_ms": ltimes["plain_ms"],
                      "call_ms": ltimes["call_ms"],
                      "ns_per_step": ltimes["ns_per_step"],
                      "library_ms": ltimes["library_ms"],
                      "bound_ms": lbound_ms, "bound_by": lbound_by},
            "note": note})
    main_t, long_t = sample_timings[ENUM_T], sample_timings[600]
    times, (bound_ms, bound_by) = main_t["times"], main_t["bound"]
    kernels.append({
        "name": "enum_chain_sample", "route": FUSED["enum_chain_sample"].route,
        "source": "src/repro_torch/csrc/enum_contract.cu",
        "replaces": FUSED["enum_chain_sample"].replaces,
        "launches": discrete_counts["enum_chain_sample"],
        "max_abs_err": max(c["mismatches"] for c in sample_checks),
        "bit_identical_cases": sum(c["bit_identical"] for c in sample_checks),
        "cases": len(sample_checks),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "call_ms": times["call_ms"], "plain_call_ms": times["plain_call_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": times["library_ms"],
        "ns_per_step": times["ns_per_step"],
        "launches_per_infer_discrete_call":
            discrete_counts["enum_chain_sample"] / DISCRETE_M,
        "shape": main_t["shape"],
        "long": {"shape": long_t["shape"], "ms": long_t["times"]["ms"],
                 "plain_ms": long_t["times"]["plain_ms"],
                 "ns_per_step": long_t["times"]["ns_per_step"],
                 "bound_ms": long_t["bound"][0],
                 "bound_by": long_t["bound"][1]},
        "note": "the backward sample of markov's forward-filter/backward-"
                "sample (infer_discrete): T dependent Gumbel-max draws in "
                "one launch (no TPU kernel: a lax.scan of "
                "random.categorical in the JAX package); max_abs_err counts "
                "draws that differ from the plain version's"})
    kernels += ensemble_kernel_rows(ens_checks, ens_timing, {
        "leapfrog_halfstep_batch": {"ChEES": (chees, chees_counts)},
        "chees_open": {"ChEES": (chees, chees_counts)},
        "chees_accept": {"ChEES": (chees, chees_counts)},
        "mala_step": {"MALA": (mala, mala_counts), "RWM": (rwm, rwm_counts)},
        "mala_accept": {"MALA": (mala, mala_counts),
                        "RWM": (rwm, rwm_counts)}})
    return kernels, data


# -- the checkpoint phase ----------------------------------------------------
# tests/test_preemption.py's sweep geometry: 24 + 36 iterations in chunks of
# 20 make exactly six checkpoint.save calls (state @20, state @24, samples
# 24-44, state @44, samples 44-60, state @60)
# lockstep NUTS is killed after save 3 and resumed from it (the orphaned
# first samples chunk); the resume from save 4 was dropped to make room for
# the svi phase (~4 s), the one from save 2 (the warmup's end; ChEES still
# resumes mid-warmup) for the mesh phase (~10 s)
CKPT_WARMUP, CKPT_DRAWS, CKPT_EVERY, CKPT_SAVES = 24, 36, 20, 6
CKPT_NUTS_CHAINS, CKPT_NUTS_KILLS = 4, (3,)
# ChEES 60 + 80 in chunks of 25, killed mid-warmup (after state @50)
CKPT_CHEES = {"warmup": 60, "draws": 80, "chains": 8, "every": 25,
              "kill": 2}
CKPT_MALA = {"warmup": 24, "draws": 36, "chains": 16, "every": 20,
             "kill": 3}
# the launcher: 4 steps checkpointed every 2, relaunched to 6
CKPT_TRAIN_FIRST, CKPT_TRAIN_STEPS, CKPT_TRAIN_EVERY = 4, 6, 2


class Preempted(BaseException):
    """The checkpoint phase's kill, raised right after a save call; only
    the phase catches it, so a real failure or a Ctrl-C still fails the
    run."""


def _dir_bytes(directory):
    return sum(os.path.getsize(os.path.join(directory, f))
               for f in os.listdir(directory))


def recorded_saves(kill_at=None, copies=None):
    """Wrap ``repro_torch.distributed.checkpoint.save`` (the executor calls
    it through the module attribute): each call's directory, step, ms and
    bytes go into the returned list; ``copies`` (save number -> path) copy
    the whole checkpoint directory right after that save, which is what a
    kill there leaves on disk; with ``kill_at`` the call of that number
    raises :class:`Preempted` once written.  Returns ``(calls, undo)``."""
    import shutil

    from repro_torch.distributed import checkpoint as ckpt
    real, calls = ckpt.save, []

    def save(tree, directory, **kwargs):
        t0 = time.perf_counter()
        real(tree, directory, **kwargs)
        calls.append({"dir": os.path.basename(directory),
                      "step": kwargs.get("step"),
                      "ms": 1e3 * (time.perf_counter() - t0),
                      "bytes": _dir_bytes(directory)})
        if copies and len(calls) in copies:
            shutil.copytree(os.path.dirname(directory), copies[len(calls)])
        if len(calls) == kill_at:
            raise Preempted(f"preempted after save #{kill_at}")

    def undo():
        ckpt.save = real

    ckpt.save = save
    return calls, undo


def run_recorded(make, args, kwargs, kill_at=None, copies=None,
                 **run_kwargs):
    """``make().run(*args, **run_kwargs, **kwargs)`` with the saves
    recorded (``recorded_saves``); with ``kill_at`` the run must stop at
    that save.  Returns ``(mcmc or None, calls, wall seconds)``."""
    calls, undo = recorded_saves(kill_at, copies)
    mcmc, t0 = make(), time.perf_counter()
    try:
        mcmc.run(*args, **run_kwargs, **kwargs)
    except Preempted:
        return None, calls, time.perf_counter() - t0
    finally:
        undo()
    check(kill_at is None, f"the run ended after {len(calls)} saves, before "
                           f"save #{kill_at}")
    return mcmc, calls, time.perf_counter() - t0


def same_leaf_bits(a, b):
    """Same Python type, dtype, shape, device and bits (NaN included)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.device == b.device
                and a.shape == b.shape and torch.equal(
                    a.detach().reshape(-1).view(torch.uint8),
                    b.detach().reshape(-1).view(torch.uint8)))
    if isinstance(a, (np.ndarray, np.generic)):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def same_tree_bits(a, b):
    from repro_torch.optim import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(map(same_leaf_bits, la, lb))


def same_run(got, want):
    """Every collected field (the draws, ``diverging``, ``accept_prob``,
    ``num_steps``, ...) and the final state bit-identical."""
    return (sorted(got._collected) == sorted(want._collected)
            and same_tree_bits(got._collected, want._collected)
            and same_tree_bits(got.last_state, want.last_state))


def saved_generators(ckdir):
    """The draw sources' generator states saved in ``ckdir/state``."""
    state = os.path.join(ckdir, "state")
    with open(os.path.join(state, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return [np.load(os.path.join(state, m["file"])).tobytes()
            for k, m in leaves.items() if k.startswith("draws/")]


def checkpoint_format_check(dev, root):
    """One tree of CUDA float32/float64/bf16/int64/bool tensors and the
    samplers' host leaves (a (C,) float32 array, ``np.float32``, ``int``,
    ``bool``) through ``save`` and ``restore``: the same bits, dtypes,
    devices and Python types come back."""
    from repro_torch.distributed import checkpoint as ckpt
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"f32": torch.randn(5, 3, device=dev, generator=g),
            "f64": torch.randn(4, dtype=torch.float64, device=dev,
                               generator=g),
            "bf16": torch.randn(7, device=dev, generator=g).bfloat16(),
            "i64": torch.randint(-2 ** 40, 2 ** 40, (6,), device=dev,
                                 generator=g),
            "bool": torch.rand(9, device=dev, generator=g) > 0.5,
            "host": (np.arange(8, dtype=np.float32) / np.float32(7),
                     np.float32(1 / 3), 5, True)}
    directory = os.path.join(root, "format")
    ckpt.save(tree, directory, step=3, extra={"k": 1})
    got, step, extra = ckpt.restore(tree, directory)
    check(step == 3 and extra == {"k": 1}, f"step {step}, extra {extra}")
    check(same_tree_bits(got, tree), "a leaf came back with other bits, "
          "dtype, device or type")
    check(got["f32"].device.type == "cuda" and type(got["host"][1])
          is np.float32, "restored leaves moved off the card or lost type")
    return {"leaves": 9, "bytes": _dir_bytes(directory)}


def checkpoint_nuts(data, root, plain_runs):
    """Lockstep NUTS on the logreg: one run killed after the last save of
    ``CKPT_NUTS_KILLS``, its checkpoint directory copied after the others
    (what a kill there leaves on disk: after save 3 the orphaned first
    samples chunk), each resumed and bit-identical to the
    uninterrupted card run (its generators' final states too), the resumed
    part launching the lockstep leaf and GLM kernels; the state write's ms
    and bytes, and the run's seconds with and without checkpoints (chunks
    of 17 against no chunking: the mesh phase's parallel run)."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS
    from repro_torch.kernels import ops

    def make():
        return MCMC(NUTS(logreg_model_glm), CKPT_WARMUP, CKPT_DRAWS,
                    num_chains=CKPT_NUTS_CHAINS)

    args, kwargs = (0, data["x"]), {"y": data["y"]}
    lines = {}
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    plain, _, plain_wall = run_recorded(make, args, kwargs)
    plain_runs["lockstep NUTS"] = (plain, ops.launch_counts())
    lines["no chunking"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole_dir = os.path.join(root, "nuts")
    whole, calls, whole_wall = run_recorded(
        make, args, kwargs, checkpoint_every=CKPT_EVERY,
        checkpoint_dir=whole_dir)
    check(len(calls) == CKPT_SAVES, f"{len(calls)} checkpoint.save calls, "
                                    f"expected {CKPT_SAVES}")
    check(same_run(whole, plain), "checkpointing changed bits of the "
                                  "lockstep NUTS run")
    generators = saved_generators(whole_dir)
    lines["uninterrupted, checkpointed"] = time.perf_counter() - t0
    state_writes = [c for c in calls if c["dir"] == "state"]
    out = {"plain_wall_seconds": plain_wall,
           "plain_chain_seconds": plain.stats["chain_seconds"],
           "checkpointed_wall_seconds": whole_wall,
           "checkpointed_chain_seconds": whole.stats["chain_seconds"],
           "num_leapfrog": plain.stats["num_leapfrog"],
           "lockstep_leapfrogs": plain.stats["lockstep_leapfrogs"],
           "state_write_ms": [c["ms"] for c in state_writes],
           "state_write_bytes": state_writes[-1]["bytes"],
           "samples_write_ms": [c["ms"] for c in calls
                                if c["dir"] != "state"],
           "divergences": whole._divergences, "resumes": {}}
    t0 = time.perf_counter()
    kill = max(CKPT_NUTS_KILLS)
    dirs = {k: os.path.join(root, f"nuts_kill{k}") for k in CKPT_NUTS_KILLS}
    run_recorded(make, args, kwargs, kill_at=kill,
                 copies={k: d for k, d in dirs.items() if k != kill},
                 checkpoint_every=CKPT_EVERY, checkpoint_dir=dirs[kill])
    lines[f"killed after save #{kill}"] = time.perf_counter() - t0
    for k, ckdir in dirs.items():
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        resumed, more, _ = run_recorded(
            make, args, kwargs, checkpoint_every=CKPT_EVERY,
            checkpoint_dir=ckdir, resume=True)
        counts = ops.launch_counts()
        check(same_run(resumed, plain), f"lockstep NUTS resumed after save "
                                        f"#{k} differs from the "
                                        "uninterrupted card run")
        check(saved_generators(ckdir) == generators,
              f"the generators' final states differ after save #{k}")
        for name in ("nuts_leaf_batch", "glm_potential_grad"):
            check(counts[name] > 0, f"{name} did not launch in the run "
                                    f"resumed after save #{k}")
        out["resumes"][k] = {
            "resumed_at": resumed.stats["resumed_at"], "saves": len(more),
            "nuts_leaf_batch": counts["nuts_leaf_batch"],
            "glm_potential_grad": counts["glm_potential_grad"]}
        lines[f"resumed after save #{k}"] = time.perf_counter() - t0
    return out, lines


def checkpoint_ensemble(data, root, name, spec, kernels, plain_runs):
    """``name`` (ChEES or MALA) on the logreg, killed after save
    ``spec["kill"]`` and resumed: bit-identical to the uninterrupted card
    run, ``kernels`` launched in the resumed part.  The uninterrupted run
    and its launch counts go into ``plain_runs[name]``."""
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core import infer
    from repro_torch.kernels import ops
    kernel = getattr(infer, name)

    def make():
        return infer.MCMC(kernel(logreg_model_glm), spec["warmup"],
                          spec["draws"], num_chains=spec["chains"])

    args, kwargs = (0, data["x"]), {"y": data["y"]}
    ops.reset_launch_counts()
    plain, _, _ = run_recorded(make, args, kwargs)
    plain_runs[name] = (plain, ops.launch_counts())
    ckdir = os.path.join(root, name)
    run_recorded(make, args, kwargs, kill_at=spec["kill"],
                 checkpoint_every=spec["every"], checkpoint_dir=ckdir)
    ops.reset_launch_counts()
    resumed, _, _ = run_recorded(make, args, kwargs,
                                 checkpoint_every=spec["every"],
                                 checkpoint_dir=ckdir, resume=True)
    counts = ops.launch_counts()
    check(same_run(resumed, plain), f"{name} resumed after save "
                                    f"#{spec['kill']} differs from the "
                                    "uninterrupted card run")
    for k in kernels:
        check(counts[k] > 0, f"{k} did not launch in the resumed {name} run")
    out = {"resumed_at": resumed.stats["resumed_at"],
           "launches": {k: counts[k] for k in kernels}}
    if name == "ChEES":
        out["trajectory_graph"] = resumed.stats["trajectory_graph"]
        check(out["trajectory_graph"] is True, "the resumed ChEES run does "
              "not replay its trajectory from CUDA graphs")
    return out


def checkpoint_launcher(root):
    """``launch.train.main`` on the reduced gemma-2b on the card: 4 steps
    checkpointed every 2, a relaunch to 6 that resumes from step 4, the
    final parameters and optimizer state bit-identical to an uninterrupted
    6-step run."""
    import contextlib
    import io

    from repro_torch.launch import train
    from repro_torch.optim import tree_leaves
    ck = os.path.join(root, "train")
    base = ["--arch", "gemma-2b", "--reduced", "--log-every", "100"]
    every = ["--ckpt-dir", ck, "--checkpoint-every", str(CKPT_TRAIN_EVERY)]
    train.main(base + ["--steps", str(CKPT_TRAIN_FIRST)] + every)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        resumed, _ = train.main(base + ["--steps", str(CKPT_TRAIN_STEPS)]
                                + every)
    print(printed.getvalue(), end="", flush=True)
    check(f"[train] resumed from step {CKPT_TRAIN_FIRST}"
          in printed.getvalue(), "the relaunch did not resume from step "
                                 f"{CKPT_TRAIN_FIRST}")
    whole, _ = train.main(base + ["--steps", str(CKPT_TRAIN_STEPS)])
    check(resumed["step"] == whole["step"] == CKPT_TRAIN_STEPS,
          f"steps {resumed['step']}, {whole['step']}")
    check(same_tree_bits(resumed, whole), "the resumed launcher's "
          "parameters or optimizer state differ from the uninterrupted run")
    return {"leaves": len(tree_leaves(whole)),
            "state_bytes": _dir_bytes(ck),
            "device": str(whole["params"]["embed"].device)}


# -- the svi phase ------------------------------------------------------------
# benchmarks/svi_minibatch.py's logistic regression on the 581,012 x 54 data
# with AutoNormal and Adam(5e-2): full batch, then its sweep's smallest
# minibatch (n / 100); each run's steps are what its gates need (the
# benchmark runs 1000): the full batch is within 0.02 of true_w by 400; the
# minibatch fit's median jitters ~0.026 a coordinate at this learning rate
# however long it runs (a CPU run at full size), so it takes the benchmark's
# 1000
SVI_LR, SVI_SUBSAMPLE = 5e-2, N // 100
SVI_STEPS = {"full": 400, "minibatch": 1000}
SVI_TOL = 0.1  # max |median(m) - true_w|, and full against minibatch
SVI_PROFILE_STEPS = 5
SVI_COPY_REPS = 100  # the minibatch's two index copies, timed alone


def _svi(n, subsample_size):
    from repro_torch import optim
    from repro_torch.bench.models import svi_logreg_model
    from repro_torch.core.infer import SVI, AutoNormal, Trace_ELBO
    model = svi_logreg_model(n, subsample_size)
    guide = AutoNormal(model)
    return SVI(model, guide, optim.adam(SVI_LR), Trace_ELBO()), guide


def svi_profile(dev):
    """Device busy share and kernels a step of both SVI fits under
    ``torch.profiler`` (``device_profile``), each warmed by 2 steps.  Run
    early in the process, as ``backward_kernel_split`` is (late in a long
    process the profiler lost records of SVI's steps): the step's kernels do
    not depend on the data's values, so the data is drawn on the card at
    the fits' shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, D), generator=gen, device=dev)
    y = (torch.rand(N, generator=gen, device=dev) < 0.5).float()
    out = {}
    for name, sub in (("full", None), ("minibatch", SVI_SUBSAMPLE)):
        svi, _ = _svi(N, sub)
        state = [svi.init(0, x, y)]
        for _ in range(2):
            state[0] = svi.update(state[0], x, y)[0]

        def step():
            state[0] = svi.update(state[0], x, y)[0]

        out[name] = device_profile(step, SVI_PROFILE_STEPS)
    return out


class _TimedIndexDraws:
    """Wall seconds spent in the plate's minibatch index draw
    (``primitives._subsample_indices``: the CPU ``randperm`` and its
    slice) while the block runs, and the number of draws."""

    def __enter__(self):
        from repro_torch.core import primitives
        self._mod, self._fn = primitives, primitives._subsample_indices
        self.seconds, self.draws = 0.0, 0

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return self._fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.draws += 1

        primitives._subsample_indices = timed
        return self

    def __exit__(self, *exc):
        self._mod._subsample_indices = self._fn
        return False


def index_copy_ms(dev, reps=SVI_COPY_REPS):
    """Wall ms of the minibatch's two host -> card index copies (``x``'s
    and ``y``'s, as ``subsample`` makes them) on an idle card."""
    from repro_torch.core.primitives import _subsample_indices
    idx = _subsample_indices(N, SVI_SUBSAMPLE,
                             torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        idx.to(dev)
        idx.to(dev)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def run_svi(dev, data):
    """SVI through the user's entry points on the card: ``SVI.run`` of the
    logistic regression with ``AutoNormal``, full batch and with minibatches
    of n / 100; gated on the loss falling (the median of the last 50 steps'
    losses below the first 50's), ``max|median(m) - true_w| < 0.1`` and the
    two fits' medians within 0.1 of each other; ms and host syncs a step,
    peak memory, the plate's index draw a step (the profile is
    :func:`svi_profile`'s, taken early in the process)."""
    x = torch.from_numpy(data["x"]).to(dev)
    y = torch.from_numpy(data["y"]).to(dev)
    true_w = data["true_w"].astype(np.float64)
    out, medians = {}, {}
    for name, sub in (("full", None), ("minibatch", SVI_SUBSAMPLE)):
        svi, guide = _svi(N, sub)
        steps = SVI_STEPS[name]
        reset_peak(dev)
        torch.cuda.synchronize()
        with _TimedIndexDraws() as draws:
            t0 = time.perf_counter()
            state, losses = svi.run(0, steps, x, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        losses = losses.cpu().numpy()
        m = guide.median(svi.get_params(state))["m"].detach().cpu().numpy()
        medians[name] = m
        syncs = count_syncs(lambda: svi.update(state, x, y))
        first, last = float(np.median(losses[:50])), float(
            np.median(losses[-50:]))
        err = float(np.max(np.abs(m - true_w)))
        out[name] = {"subsample_size": sub or N, "steps": steps,
                     "seconds": wall, "ms_per_step": 1e3 * wall / steps,
                     "steps_per_s": steps / wall,
                     "host_syncs_per_step": syncs,
                     "median_loss_first_50": first,
                     "median_loss_last_50": last,
                     "max_abs_median_m_minus_true_w": err,
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev)
                     / 1e9}
        if sub is not None:
            # one draw a step, and those of init's traces
            check(draws.draws >= steps, f"SVI {name}: {draws.draws} index "
                                        f"draws in {steps} steps")
            out[name]["index_draws"] = draws.draws
            out[name]["index_draw_ms"] = 1e3 * draws.seconds / draws.draws
            out[name]["index_copies_ms_per_step"] = index_copy_ms(dev)
        check(bool(np.isfinite(losses).all()), f"SVI {name}: a loss is not "
                                               "finite")
        check(last < first, f"SVI {name}: the loss did not fall ({first} -> "
                            f"{last})")
        check(err < SVI_TOL, f"SVI {name}: median(m) is {err} from true_w")
    agree = float(np.max(np.abs(medians["full"] - medians["minibatch"])))
    out["max_abs_full_minus_minibatch"] = agree
    check(agree < SVI_TOL, f"SVI: the full-batch and minibatch medians "
                           f"differ by {agree}")
    print("svi:", json.dumps(out), flush=True)
    return out


def run_checkpoint(dev, data):
    """The checkpoint phase: kill and resume on the card through the user's
    entry points, each check's seconds printed; the checkpoints live under
    a temporary directory removed at the end.  Returns ``(results,
    plain_runs)``: the uninterrupted lockstep NUTS, ChEES and MALA runs
    with their launch counts, which the obs phase holds its runs with
    telemetry against."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp()
    seconds, out, plain_runs = {}, {}, {}
    try:
        for name, fn in (
                ("format", lambda: checkpoint_format_check(dev, root)),
                ("lockstep NUTS", lambda: checkpoint_nuts(data, root,
                                                          plain_runs)),
                ("ChEES", lambda: checkpoint_ensemble(
                    data, root, "ChEES", CKPT_CHEES,
                    ("chees_open", "chees_accept", "glm_potential_grad"),
                    plain_runs)),
                ("MALA", lambda: checkpoint_ensemble(
                    data, root, "MALA", CKPT_MALA,
                    ("mala_step", "mala_accept", "glm_potential_grad"),
                    plain_runs)),
                ("launcher", lambda: checkpoint_launcher(root))):
            t0 = time.perf_counter()
            result = fn()
            seconds[name] = time.perf_counter() - t0
            if name == "lockstep NUTS":
                result, lines = result
                for line, secs in lines.items():
                    print(f"checkpoint: lockstep NUTS, {line}: {secs:.2f} s",
                          flush=True)
            out[name] = result
            print(f"checkpoint: {name}: {seconds[name]:.2f} s",
                  json.dumps(result), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("checkpoint part seconds:", json.dumps(seconds), flush=True)
    return out, plain_runs



# -- the mesh phase ----------------------------------------------------------
# the segmented GLM kernel (glm_potential_partials: row 2's kernel over a
# shard grid dimension) against its plain loop and against one-shard
# launches, then the checkpoint phase's lockstep NUTS logreg with
# data_shards=4 under chain_method="parallel" on a one-rank mesh
MESH_SHARDS = (1, 2, 4)           # at the main shape (n = 4 * 145,253)
MESH_SMALL = (28_028, 7, (1, 2, 4, 7))   # n divisible by 7
MESH_CHAINS = (1, 8, 16)
MESH_TIMED = ((1, 1), (2, 1), (4, 1), (1, 8), (2, 8), (4, 8))  # (S, C)
MESH_DATA_SHARDS = 4
# the sharded logreg runs take the checkpoint phase's geometry (4 chains,
# 24 + 36), whose uninterrupted run is the same run without shards; the
# parallel one is checkpointed every 17 (saves: state @17, @24,
# samples_24_41, state @41, samples_41_58, state @58, samples_58_60, state
# @60: chunks that do not divide the phases, against the unchunked run) and
# resumed from a copy made after save 5, the orphaned second samples write
MESH_EVERY, MESH_COPY_AT = 17, 5


def start_one_rank_group():
    """A one-rank process group in this process for the mesh phase: NCCL,
    or gloo (with CUDA tensors) where NCCL cannot start; returns the
    backend's name."""
    import torch.distributed as tdist
    if tdist.is_initialized():
        return tdist.get_backend()
    try:
        tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                                 world_size=1)
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    except Exception as e:  # noqa: BLE001 — reported, then gloo
        print(f"mesh: NCCL did not start ({type(e).__name__}: {e}); "
              "using gloo with CUDA tensors", flush=True)
        if tdist.is_initialized():
            tdist.destroy_process_group()
        tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0,
                                 world_size=1)
    return tdist.get_backend()


def partials_bound(n, d, chains, shards):
    """X, y and the offset read once, w read, (C, S) partials written."""
    nbytes = 4 * (n * d + 2 * n + chains * d + chains * shards * (d + 1))
    return bound(nbytes, n * (4 * d + 12) * chains, torch.float32)


def partials_checks(dev):
    """The segmented kernel at the main shape (S = 1, 2, 4; bernoulli_logit
    with an offset) and at (28,028, 7) (S = 1, 2, 4, 7; both families), C =
    1, 8, 16: one launch and C * S shard evaluations a call, every partial
    within row 2's bound of the float64 plain loop and bit-identical to a
    separate one-shard launch on its rows (the same view: shard k of the
    main shape starts 16-byte aligned only for even k, the odd ones take
    the 4-byte copy path).  Times the main shape's calls at MESH_TIMED
    beside S one-shard launches and the unsharded launch, and one shard's
    launch at an even and an odd shard."""
    from repro_torch.kernels.glm_potential import (
        glm_potential_grad_cuda, glm_potential_partials_cuda,
        glm_potential_partials_ref)
    results, timing = [], {}
    cmax = max(MESH_CHAINS)
    cases = [(N, D, MESH_SHARDS, "bernoulli_logit", None)] + [
        (MESH_SMALL[0], MESH_SMALL[1], MESH_SMALL[2], fam, scale)
        for fam, scale in (("bernoulli_logit", None), ("normal", 0.7))]
    for n, d, shard_counts, family, scale in cases:
        gen = torch.Generator().manual_seed(n + d + 1)
        x = torch.randn((n, d), generator=gen).to(dev)
        w_all = (0.3 * torch.randn((cmax, d), generator=gen)).to(dev)
        off = (0.2 * torch.randn(n, generator=gen)).to(dev)
        if family == "bernoulli_logit":
            y = (torch.rand(n, generator=gen) < 0.5).float().to(dev)
        else:
            y = x @ w_all[0] + 0.5 * torch.randn(n, generator=gen).to(dev)
        xd = x.double()
        logits = xd @ w_all.double().T + off.double()[:, None]  # (n, C)
        if family == "bernoulli_logit":
            resid = torch.sigmoid(logits) - y.double()[:, None]
            terms = torch.nn.functional.softplus(logits) \
                - y.double()[:, None] * logits
        else:
            resid = (logits - y.double()[:, None]) / scale ** 2
            terms = 0.5 * ((logits - y.double()[:, None]) / scale) ** 2 \
                + math.log(scale)
        err = worst = 0.0
        for shards in shard_counts:
            m = n // shards
            # row 2's bound, shard by shard: 5e-3 + 1e-5 * sum |terms|
            tol_v = 5e-3 + GLM_REL_TOL * terms.abs().reshape(
                shards, m, cmax).sum(1).T                       # (C, S)
            tol_g = 5e-3 + GLM_REL_TOL * torch.einsum(
                "scm,smd->csd", resid.abs().reshape(shards, m, cmax)
                .permute(0, 2, 1), xd.abs().reshape(shards, m, d))
            want_v, want_g = glm_potential_partials_ref(
                x, y, w_all.double(), off, scale, family,
                data_shards=shards, compute_dtype=torch.float64)
            for chains in MESH_CHAINS:
                w = w_all[:chains].contiguous()
                glm_potential_partials_cuda.launches = 0
                glm_potential_partials_cuda.shard_evals = 0
                kv, kg = glm_potential_partials_cuda(
                    x, y, w, off, scale, family, data_shards=shards)
                check((glm_potential_partials_cuda.launches,
                       glm_potential_partials_cuda.shard_evals)
                      == (1, chains * shards),
                      f"a {chains}-chain {shards}-shard call made "
                      f"{glm_potential_partials_cuda.launches} launches and "
                      f"{glm_potential_partials_cuda.shard_evals} shard "
                      "evaluations")
                ev = (kv.double() - want_v[:chains]).abs()
                eg = (kg.double() - want_g[:chains]).abs()
                check(bool((ev <= tol_v[:chains]).all())
                      and bool((eg <= tol_g[:chains]).all()),
                      f"partials disagree with the plain loop at n={n} "
                      f"d={d} {family} S={shards} C={chains}: nll err "
                      f"{float(ev.max())}, grad err {float(eg.max())}")
                err = max(err, float(ev.max()), float(eg.max()))
                worst = max(worst, float((ev / tol_v[:chains]).max()),
                            float((eg / tol_g[:chains]).max()))
                for k in range(shards):
                    rows = slice(k * m, (k + 1) * m)
                    sv, sg = glm_potential_grad_cuda(
                        x[rows], y[rows], w, off[rows], scale, family)
                    check(torch.equal(kv[:, k], sv)
                          and torch.equal(kg[:, k], sg),
                          f"shard {k} of {shards} (C={chains}, n={n}) is "
                          "not bit-identical to a one-shard launch on its "
                          "rows")
                if (n, family) == (N, "bernoulli_logit") \
                        and (shards, chains) in MESH_TIMED:
                    views = [(x[k * m:(k + 1) * m], y[k * m:(k + 1) * m],
                              off[k * m:(k + 1) * m]) for k in range(shards)]
                    times = timings(
                        lambda: glm_potential_partials_cuda(
                            x, y, w, off, scale, family, data_shards=shards),
                        lambda: glm_potential_partials_ref(
                            x, y, w, off, scale, family, data_shards=shards),
                        20)
                    times["separate_launches_ms"] = device_ms(
                        lambda: [glm_potential_grad_cuda(xv, yv, w, ov)
                                 for xv, yv, ov in views], 20)
                    times["unsharded_ms"] = device_ms(
                        lambda: glm_potential_grad_cuda(x, y, w, off), 20)
                    if shards > 1:
                        times["one_shard_ms"] = {
                            f"shard {k} ({'aligned' if k % 2 == 0 else 'odd: 4-byte copies'})":
                            device_ms(lambda v=views[k]: glm_potential_grad_cuda(
                                v[0], v[1], w, v[2]), 20) for k in (0, 1)}
                    timing[(shards, chains)] = (
                        times, partials_bound(n, d, chains, shards))
        results.append({"n": n, "d": d, "family": family,
                        "shards": list(shard_counts),
                        "chains": list(MESH_CHAINS), "max_abs_err": err,
                        "worst_err_over_tol": worst,
                        "tol": "5e-3 + 1e-5 * sum|terms| a shard (row 2's)",
                        "bit_identical_to_one_shard_launches": True})
    glm_potential_partials_cuda.launches = 0
    glm_potential_partials_cuda.chain_evals = 0
    glm_potential_partials_cuda.shard_evals = 0
    return results, timing


def mesh_run_gates(run, counts, chain_evals, shard_evals, data, label):
    """A data-sharded lockstep logreg run: the lockstep gates, one
    ``glm_potential_partials`` launch a gradient (the lockstep gradients,
    the chains' search evaluations and the setup's check) and none of the
    one-shard GLM op, C * S shard evaluations, 0 divergences and the
    pooled mean within 0.05 of ``true_w``."""
    stats = run.stats
    leaves, init = stats["lockstep_leapfrogs"], stats["init_grad_evals"]
    lockstep_gates(counts, stats)
    check(counts["glm_potential_partials"] == leaves + init + 1,
          f"{label}: glm_potential_partials {counts['glm_potential_partials']}"
          f" launches != {leaves} lockstep gradients + {init} search "
          "evaluations + 1 (the setup's check)")
    check(counts["glm_potential_grad"] == 0,
          f"{label}: {counts['glm_potential_grad']} one-shard GLM launches")
    check(chain_evals == stats["num_grad_evals"] + 1
          and shard_evals == MESH_DATA_SHARDS * chain_evals,
          f"{label}: {chain_evals} chain and {shard_evals} shard "
          f"evaluations for {stats['num_grad_evals']} gradients + 1")
    w = run.get_samples(group_by_chain=True)["w"].detach().cpu().numpy()
    extra = run.get_extra_fields()
    divergences = int(extra["diverging"].sum())
    post_err = float(np.max(np.abs(w.mean((0, 1)) - data["true_w"])))
    check(np.all(np.isfinite(w)), f"{label}: draws not finite")
    check(divergences == 0, f"{label}: {divergences} divergent transitions")
    check(post_err < 0.05, f"{label}: pooled posterior mean is {post_err} "
                           "from true_w")
    return {"chain_seconds": stats["chain_seconds"],
            "lockstep_leapfrogs": leaves, "num_leapfrog":
            stats["num_leapfrog"],
            "ms_per_lockstep_leapfrog": 1e3 * stats["chain_seconds"] / leaves,
            "num_grad_evals": stats["num_grad_evals"],
            "init_grad_evals": init, "host_syncs": stats["host_syncs"],
            "launches": {k: counts[k] for k in (
                "glm_potential_partials", "glm_potential_grad",
                "nuts_leaf_batch", "halfstep_chains")},
            "chain_evals": chain_evals, "shard_evals": shard_evals,
            "divergences": divergences,
            "max_abs_posterior_mean_minus_true_w": post_err}


def mesh_logreg(data, plain_nuts):
    """The checkpoint phase's lockstep NUTS logreg (``CKPT_WARMUP`` +
    ``CKPT_DRAWS``, ``CKPT_NUTS_CHAINS`` chains) with ``data_shards=4``:
    under ``"vectorized"``, under ``"parallel"`` on the one-rank (1, 1)
    mesh checkpointed every ``MESH_EVERY`` (byte-identical: also the check
    that chunks of 17 move no bit, which the checkpoint phase made before
    the mesh phase came), and that checkpoint, copied after save
    ``MESH_COPY_AT`` (an orphaned samples write), resumed under
    ``"vectorized"`` (byte-identical); each sharded run gated by
    :func:`mesh_run_gates`; ms a lockstep leapfrog beside the checkpoint
    phase's uninterrupted run, the same run without shards
    (``plain_nuts``: the MCMC and its launch counts)."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS
    from repro_torch.kernels import ops
    from repro_torch.kernels.glm_potential import glm_potential_partials_cuda

    def make(**kw):
        return MCMC(NUTS(logreg_model_glm, data_shards=MESH_DATA_SHARDS),
                    CKPT_WARMUP, CKPT_DRAWS, num_chains=CKPT_NUTS_CHAINS,
                    **kw)

    def counted(fn, label):
        ops.reset_launch_counts()
        run = fn()
        out = mesh_run_gates(run, ops.launch_counts(),
                             glm_potential_partials_cuda.chain_evals,
                             glm_potential_partials_cuda.shard_evals, data,
                             label)
        return run, out

    args, kwargs = (0, data["x"]), {"y": data["y"]}
    out = {}
    vec, out["vectorized"] = counted(
        lambda: run_recorded(make, args, kwargs)[0], "vectorized")
    root = tempfile.mkdtemp()
    tele = obs.Telemetry()
    try:
        copy = os.path.join(root, f"after_save_{MESH_COPY_AT}")
        par, out["parallel (1, 1)"] = counted(lambda: run_recorded(
            lambda: make(chain_method="parallel", mesh_shape=(1, 1),
                         telemetry=tele), args,
            kwargs, copies={MESH_COPY_AT: copy}, checkpoint_every=MESH_EVERY,
            checkpoint_dir=os.path.join(root, "parallel"))[0],
            "parallel (1, 1)")
        check(same_run(par, vec), "parallel (1, 1) with telemetry is not "
                                  "byte-identical to vectorized")
        series = tele.buffer.series()
        check(bool(series) and all(
            np.shape(v) == (CKPT_NUTS_CHAINS, CKPT_DRAWS)
            for v in series.values()),
            f"the parallel run's metric series: "
            f"{ {k: np.shape(v) for k, v in series.items()} }")
        out["parallel (1, 1)"]["telemetry"] = {
            "metrics": sorted(series), "chunks": len(chunk_spans(tele)),
            "mean_accept_prob": float(np.mean(series["accept_prob"]))}
        with open(os.path.join(root, "parallel", "state",
                               "manifest.json")) as f:
            extra = json.load(f)["extra"]
        check((extra["mesh_shape"], extra["num_devices"]) == ([1, 1], 1),
              f"the checkpoint records mesh {extra['mesh_shape']} on "
              f"{extra['num_devices']} devices")
        t0 = time.perf_counter()
        resumed = run_recorded(make, args, kwargs,
                               checkpoint_every=MESH_EVERY,
                               checkpoint_dir=copy, resume=True)[0]
        check(same_run(resumed, vec), "the parallel checkpoint resumed under "
                                      "vectorized is not byte-identical")
        out["resumed under vectorized"] = {
            "resumed_at": resumed.stats["resumed_at"],
            "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    plain = plain_nuts[0].stats
    out["no shards (the checkpoint phase's run)"] = {
        "chain_seconds": plain["chain_seconds"],
        "lockstep_leapfrogs": plain["lockstep_leapfrogs"],
        "ms_per_lockstep_leapfrog": 1e3 * plain["chain_seconds"]
        / plain["lockstep_leapfrogs"]}
    return out


def run_mesh(dev, data, plain_nuts):
    """The mesh phase: a one-rank group, the segmented kernel's checks and
    times, the sharded logreg runs; returns row 2b of the kernel table."""
    import torch.distributed as tdist

    from repro_torch.kernels.ops import FUSED
    seconds, t0 = {}, time.perf_counter()
    backend = start_one_rank_group()
    seconds["group"] = time.perf_counter() - t0
    print(f"mesh: a one-rank {backend} group", flush=True)
    t0 = time.perf_counter()
    checks, timing = partials_checks(dev)
    seconds["kernel checks"] = time.perf_counter() - t0
    print("mesh: glm_potential_partials checks:", json.dumps(checks),
          flush=True)
    print("mesh: glm_potential_partials timings (S, C):", json.dumps(
        {f"{s}, {c}": {**t, "bound_ms": b, "bound_by": by}
         for (s, c), (t, (b, by)) in timing.items()}), flush=True)
    t0 = time.perf_counter()
    runs = mesh_logreg(data, plain_nuts)
    seconds["logreg runs"] = time.perf_counter() - t0
    print(f"mesh: logreg, {CKPT_NUTS_CHAINS} chains, {CKPT_WARMUP} + "
          f"{CKPT_DRAWS}, data_shards={MESH_DATA_SHARDS}:", json.dumps(runs),
          flush=True)
    tdist.destroy_process_group()
    print("mesh part seconds:", json.dumps(seconds), flush=True)
    name = "glm_potential_partials"
    spec = FUSED[name]
    times, (bound_ms, bound_by) = timing[(MESH_DATA_SHARDS, 1)]
    phases = ("vectorized", "parallel (1, 1)")
    return {
        "name": name, "kernel": "glm_chains_kernel (gridDim.z = S)",
        "route": spec.route, "source": "src/repro_torch/csrc/glm_potential.cu",
        "replaces": spec.replaces,
        "launches": sum(runs[p]["launches"][name] for p in phases),
        "launches_by_phase": {p: runs[p]["launches"][name] for p in phases},
        "launches_per_gradient": {
            p: runs[p]["launches"][name] / (runs[p]["lockstep_leapfrogs"]
                                            + runs[p]["init_grad_evals"] + 1)
            for p in phases},
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "call_ms": times["call_ms"], "plain_call_ms": times["plain_call_ms"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "shape": [N, D], "shards": MESH_DATA_SHARDS, "chains": 1,
        "by_shards_chains": {f"{s}, {c}": {**t, "bound_ms": b,
                                          "bound_by": by}
                             for (s, c), (t, (b, by)) in timing.items()},
        "seconds": seconds}


# -- the lint phase ----------------------------------------------------------
LINT_VALIDATE = (10, 10)   # warmup, draws of the validate= check


def _meta(value):
    """``value`` with every numpy array or tensor as an empty tensor of its
    shape and dtype on the meta device."""
    from torch.utils._pytree import tree_map

    def empty(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if isinstance(leaf, torch.Tensor):
            return torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
        return leaf
    return tree_map(empty, value)


def lint_models(data):
    """The three paper models with the main paths' data: (label, model,
    args, kwargs)."""
    from repro_torch.bench.models import (hmm_data, hmm_model,
                                          logreg_model_glm, skim_data,
                                          skim_model)
    hmm = hmm_data(seed=0, T=HMM_T, T_sup=HMM_T_SUP, K=HMM_K, V=HMM_V)
    sk = skim_data(SKIM_P, seed=0, n=SKIM_N, n_inter=SKIM_INTER)
    return [("logreg_model_glm", logreg_model_glm, (data["x"],),
             {"y": data["y"]}),
            ("hmm_model", hmm_model, (hmm,), {}),
            ("skim_model", skim_model, (sk["x"],), {"y": sk["y"]})]


def run_lint(dev, n=N):
    """The lint phase (see the module docstring) on the logreg's n x 54
    data; returns what it printed.  The registry check's launches are
    zeroed after it (every phase reads its counts from zero)."""
    from repro_torch.bench.models import covtype_data
    from repro_torch import lint
    from repro_torch.core import lint as core_lint
    from repro_torch.core.infer import MCMC, NUTS, hmc_setup
    from repro_torch.core.infer.hmc_util import GeneratorDraws, value_and_grad
    from repro_torch.core.infer.mcmc import _to_device
    from repro_torch.kernels import ops
    out, part_s = {}, {}
    t0 = time.perf_counter()
    data = covtype_data(seed=0, n=n, d=D)
    part_s["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    registry = lint.verify_registry(device=dev)
    ops.reset_launch_counts()
    part_s["registry"] = time.perf_counter() - t0
    rows = [s for s in list(ops.OP_TABLE) + list(ops.FUSED.values())
            + list(ops.BACKWARD.values()) if s.kernel is not None]
    out["registry"] = {"findings": [str(f) for f in registry.findings],
                       "rows": registry.details}
    print("lint registry (RPL201-203):", json.dumps(out["registry"]),
          flush=True)
    check(registry.ok and not registry.findings,
          f"RPL201-203 findings:\n{registry}")
    check(len(rows) == 26 and all(
        (registry.details.get(s.name) or {}).get("launches", 0) >= 1
        for s in rows), "a registered kernel did not launch against its "
          f"plain version: {registry.details}")
    t0 = time.perf_counter()
    models = lint_models(data)
    out["models"] = {}
    for label, model, args, kwargs in models:
        on_card = lint.lint_model(model, args, kwargs, device=dev)
        abstract = lint.lint_model(model, _meta(args), _meta(kwargs))
        out["models"][label] = {"card": str(on_card), "meta": str(abstract)}
        check(on_card.ok and not on_card.findings
              and abstract.ok and not abstract.findings,
              f"lint of {label}: card {on_card}; meta {abstract}")
    part_s["models"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["hazards"] = {}
    for label, model, args, kwargs in models:
        setup = hmc_setup(torch.Generator().manual_seed(0), 10, algo="NUTS",
                          model=model, model_args=_to_device(args, dev),
                          model_kwargs=_to_device(kwargs, dev), device=dev)
        z = setup.init_fn(GeneratorDraws(torch.Generator().manual_seed(1))).z
        result = lint.analyze(value_and_grad(setup.potential_fn), z)
        out["hazards"][label] = [str(f) for f in result.findings]
    part_s["hazards"] = time.perf_counter() - t0
    print("lint hazards (analyze of each potential and gradient):",
          json.dumps(out["hazards"]), flush=True)
    t0 = time.perf_counter()
    linted, real = [], core_lint.lint_model

    def counting(*a, **k):
        linted.append(1)
        return real(*a, **k)

    from repro_torch.bench.models import logreg_model_glm
    draws = {}
    core_lint.lint_model = counting
    try:
        for validate in (True, False):
            mcmc = MCMC(NUTS(logreg_model_glm), *LINT_VALIDATE,
                        validate=validate)
            mcmc.run(0, data["x"], y=data["y"])
            if validate:
                mcmc.run(0, data["x"], y=data["y"])  # warm: no lint
            draws[validate] = mcmc.get_samples()["w"]
    finally:
        core_lint.lint_model = real
    out["validate"] = {"lint_calls": len(linted), "bit_identical": bool(
        torch.equal(draws[True], draws[False]))}
    check(out["validate"] == {"lint_calls": 1, "bit_identical": True},
          f"validate=True: {out['validate']}")
    part_s["validate"] = time.perf_counter() - t0
    out["seconds"] = part_s
    print("lint validate:", json.dumps(out["validate"]), flush=True)
    return out


# -- the obs phase -----------------------------------------------------------
# the checkpoint phase's configurations (CKPT_*), each run once more with
# telemetry and held against that phase's uninterrupted run without it
OBS_GATE = {"max_rhat": 1.05, "check_every": 20, "batch_size": 5,
            "max_samples": 200}


def chunk_spans(tele):
    return [s for s in tele.spans if s.name.endswith("_chunk")]


def observed_run(make, data, tele, plain_run, what, **run_kwargs):
    """``make(tele)`` run on the logreg from zeroed launch counters and
    held against ``plain_run`` (the same configuration without telemetry,
    and its launch counts): every collected field and the final state
    bit-identical, every launch count equal.  Returns the run."""
    from repro_torch.kernels import ops
    off, c_off = plain_run
    ops.reset_launch_counts()
    on = make(tele).run(0, data["x"], y=data["y"], **run_kwargs)
    c_on = ops.launch_counts()
    check(same_run(on, off), f"telemetry changed bits of the {what} run")
    check(c_on == c_off, f"telemetry changed the {what} run's launch "
                         f"counts: {c_on} against {c_off}")
    return on


def obs_nuts(data, root, card, plain_run):
    """Lockstep NUTS with telemetry, in chunks of 20, against the same run
    without it; then gated: see the module docstring.  Returns what it
    measured."""
    from repro_torch import obs
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core.infer import MCMC, NUTS
    from repro_torch.obs.manifest import RunManifest
    from repro_torch.obs.validate import validate_events, validate_manifest

    def make(telemetry):
        return MCMC(NUTS(logreg_model_glm), CKPT_WARMUP, CKPT_DRAWS,
                    num_chains=CKPT_NUTS_CHAINS, telemetry=telemetry)

    directory = os.path.join(root, "nuts")
    tele = obs.Telemetry(dir=directory)
    on = observed_run(make, data, tele, plain_run, "lockstep NUTS",
                      checkpoint_every=CKPT_EVERY)
    off, counts = plain_run
    check(counts["nuts_leaf_batch"] > 0 and counts["glm_potential_grad"] > 0,
          "the lockstep NUTS run launched no leaf or GLM kernel")
    chunks = len(chunk_spans(tele))
    divergent = len({(r["iteration"] - CKPT_WARMUP) // CKPT_EVERY
                     for r in tele.forensics.records})
    extra = on.stats["host_syncs"] - off.stats["host_syncs"]
    check(extra <= chunks + divergent, f"telemetry added {extra} host syncs "
          f"over {chunks} chunks ({divergent} divergent)")
    for path, errors in (
            ("events.jsonl", validate_events(
                os.path.join(directory, "events.jsonl"))),
            (obs.MANIFEST_NAME, validate_manifest(
                os.path.join(directory, obs.MANIFEST_NAME)))):
        check(not errors, f"{path} does not validate: {errors[:3]}")
    env = RunManifest.peek(os.path.join(directory, obs.MANIFEST_NAME)).data[
        "sessions"][-1]["environment"]
    name = card.rpartition(",")[0].strip()
    check(env["device_kind"] == name, f"the manifest names "
          f"{env['device_kind']!r}, nvidia-smi {name!r}")
    check(env["power_limit_w"] is not None, "the manifest has no power limit")

    def ms(run):
        return 1e3 * run.stats["chain_seconds"] \
            / run.stats["lockstep_leapfrogs"]

    out = {"chunks": chunks, "divergent_chunks": divergent,
           "host_syncs_off": off.stats["host_syncs"],
           "host_syncs_on": on.stats["host_syncs"], "extra_syncs": extra,
           "ms_per_lockstep_leapfrog_off": ms(off),
           "ms_per_lockstep_leapfrog_on": ms(on),
           "lockstep_leapfrogs": on.stats["lockstep_leapfrogs"],
           "launches": {k: counts[k] for k in ("nuts_leaf_batch",
                                               "glm_potential_grad")},
           "manifest_card": env["device_kind"],
           "manifest_power_limit_w": env["power_limit_w"],
           "program_cold": [s.attr("program_cold") for s in
                            chunk_spans(tele)]}
    gated = make(None).run(0, data["x"], y=data["y"],
                           until=obs.Converged(**OBS_GATE))
    drawn = gated._collected["z"].shape[1]
    common = min(drawn, CKPT_DRAWS)
    check(all(torch.equal(v[:, :common], off._collected[k][:, :common])
              for k, v in gated._collected.items()),
          "the gated run's draws are not the ungated run's prefix")
    decision = gated.monitor.decision
    out["gated"] = {"decision": decision["reason"],
                    "stopped_at_draws": decision["stopped_at_draws"],
                    "stopped_at_iteration": CKPT_WARMUP + drawn,
                    "max_rhat": decision["max_rhat"],
                    "compared_draws": common,
                    "host_syncs": gated.stats["host_syncs"]}
    return out


def obs_ensemble(data, name, spec, plain_run):
    """``name`` (ChEES or MALA) on the logreg with telemetry against the
    same run without it: bit-identical, equal launch counts; ChEES graphed
    in both with equal replays, only its first chunk span
    ``program_cold`` (its CUDA graphs are captured there)."""
    from repro_torch import obs
    from repro_torch.bench.models import logreg_model_glm
    from repro_torch.core import infer
    kernel = getattr(infer, name)

    def make(telemetry):
        return infer.MCMC(kernel(logreg_model_glm), spec["warmup"],
                          spec["draws"], num_chains=spec["chains"],
                          telemetry=telemetry)

    tele = obs.Telemetry()
    on = observed_run(make, data, tele, plain_run, name)
    off = plain_run[0]
    cold = [s.attr("program_cold") for s in chunk_spans(tele)]
    out = {"program_cold": cold, "counters": dict(tele.counters),
           "host_syncs_off": off.stats["host_syncs"],
           "host_syncs_on": on.stats["host_syncs"]}
    check(on.stats["host_syncs"] - off.stats["host_syncs"]
          <= len(cold) + len({r["iteration"] >= spec["warmup"]
                              for r in tele.forensics.records}),
          f"telemetry added more than one host sync a chunk to {name}")
    if name == "ChEES":
        check(on.stats["trajectory_graph"] and off.stats["trajectory_graph"],
              "ChEES's trajectory was not graphed")
        check(on.stats["graph_replays"] == off.stats["graph_replays"],
              "telemetry changed ChEES's graph replays")
        check(cold == [True] + [False] * (len(cold) - 1),
              f"program_cold should mark the first chunk span only: {cold}")
        out["graph_replays"] = on.stats["graph_replays"]
    return out


def run_obs(dev, data, card, plain_runs):
    """The obs phase (see the module docstring) against the checkpoint
    phase's uninterrupted runs (``plain_runs``); each check's seconds
    printed, the artifacts under a temporary directory removed at the
    end."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp()
    seconds, out = {}, {}
    try:
        for name, fn in (
                ("lockstep NUTS", lambda: obs_nuts(
                    data, root, card, plain_runs["lockstep NUTS"])),
                ("ChEES", lambda: obs_ensemble(data, "ChEES", CKPT_CHEES,
                                               plain_runs["ChEES"])),
                ("MALA", lambda: obs_ensemble(data, "MALA", CKPT_MALA,
                                              plain_runs["MALA"]))):
            t0 = time.perf_counter()
            out[name] = fn()
            seconds[name] = time.perf_counter() - t0
            print(f"obs: {name}: {seconds[name]:.2f} s",
                  json.dumps(out[name]), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("obs part seconds:", json.dumps(seconds), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build_s = _build.build_all(["leapfrog", "glm_potential",
                                "enum_contract", "leapfrog_batch", "chees",
                                "mala_step", "rmsnorm", "flash_attention",
                                "flash_attention_bwd", "softmax_xent",
                                "ssd_scan"])
    print("build seconds:", json.dumps(build_s), flush=True)
    print("tensor-core kernels (cuobjdump):", json.dumps(tc_kernel_usage()),
          flush=True)
    print("backward kernels by device time (ms per call):",
          json.dumps(backward_kernel_split(dev)), flush=True)
    t0 = time.perf_counter()
    svi_prof = svi_profile(dev)
    svi_prof["seconds"] = time.perf_counter() - t0
    print("svi profile:", json.dumps(svi_prof), flush=True)
    phase_s = {}
    t0 = time.perf_counter()
    lint_out = run_lint(dev)
    phase_s["lint"] = time.perf_counter() - t0
    print("lint phase seconds:", json.dumps(
        {"total": phase_s["lint"], **lint_out["seconds"]}), flush=True)
    t0 = time.perf_counter()
    kernels, data = run_samplers(dev)
    phase_s["samplers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, plain_runs = run_checkpoint(dev, data)
    phase_s["checkpoint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels.append(run_mesh(dev, data, plain_runs["lockstep NUTS"]))
    phase_s["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_obs(dev, data, card, plain_runs)
    del plain_runs
    phase_s["obs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_svi(dev, data)
    del data
    torch.cuda.empty_cache()
    phase_s["svi"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_checks, lm_timing = lm_kernel_checks(dev)
    print("LM kernel checks:", json.dumps(lm_checks), flush=True)
    print("LM kernel timings:", json.dumps(
        {str(k): v for k, v in lm_timing.items()}), flush=True)
    lm = run_lm(dev)
    torch.cuda.empty_cache()
    run_lm_f32_check(dev)
    torch.cuda.empty_cache()
    phase_s["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr_checks, tr_timing = train_kernel_checks(dev)
    print("train kernel checks:", json.dumps(tr_checks), flush=True)
    print("train kernel timings:", json.dumps(tr_timing), flush=True)
    train = run_train(dev)
    torch.cuda.empty_cache()
    run_train_f32_check(dev)
    phase_s["train"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssm_checks, ssm_timing = ssm_kernel_checks(dev)
    print("ssm kernel checks:", json.dumps(ssm_checks), flush=True)
    print("ssm kernel timings:", json.dumps(ssm_timing), flush=True)
    ssm = run_ssm(dev)
    torch.cuda.empty_cache()
    run_ssm_f32_check(dev)
    phase_s["ssm"] = time.perf_counter() - t0
    kernels += lm_kernel_rows(lm_checks, lm_timing, lm, train, ssm)
    kernels += train_kernel_rows(tr_timing, tr_checks, train)
    kernels += ssm_kernel_rows(ssm_checks, ssm_timing, ssm)
    print("phase seconds:", json.dumps(phase_s), flush=True)
    print("wall seconds:", time.perf_counter() - t_start, flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
