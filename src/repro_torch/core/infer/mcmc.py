"""The MCMC executor.

Per-chain kernels (HMC, NUTS) run their chains in one of two ways, each
chain with its own draw source (a CPU ``torch.Generator`` seeded from
``np.random.SeedSequence(seed)``):

- ``chain_method="vectorized"`` (the default) with more than one chain moves
  them in lockstep, the JAX executor's ``vmap`` over chains: one
  ``init_batch_fn`` over all chains' draw sources, then ``num_warmup +
  num_samples`` batched transitions (``sample_batch_fn``), in which every
  lockstep leaf of NUTS is one leaf kernel launch and one potential
  evaluation for all the chains still growing their trees.  Each chain
  draws exactly what it would draw alone, so on the CPU chain c is the same
  chain as under ``"sequential"``, bit for bit.
- ``chain_method="sequential"`` runs them one after another: ``init_fn``
  and ``num_warmup + num_samples`` calls of ``sample_fn`` each.

Cross-chain kernels (``KernelSetup.cross_chain``: ChEES, MALA, RWM) move
the whole ensemble at once: ``init_fn`` is called once with every chain's
draw source and the shared one, then ``sample_fn`` ``num_warmup +
num_samples`` times with the shared source.  HMC/NUTS with
``cross_chain_adapt=True`` is cross-chain and runs the lockstep path.
Cross-chain kernels adapt across the chains, so
``chain_method="sequential"`` raises for them.

Fault tolerance, as in the JAX package's executor: every path runs its
iterations in chunks, ``checkpoint_every`` of them (all of warmup, then all
of sampling, without it); a chunk never mixes warmup and sampling, and its
boundaries depend only on ``(num_warmup, num_samples, checkpoint_every,
done)``, so ``checkpoint_every`` moves no bit of the draws.
``run(..., checkpoint_every=k, checkpoint_dir=d)`` writes after each chunk,
through :mod:`repro_torch.distributed.checkpoint` (the JAX package's
format): each sampling chunk's draws once to ``d/samples_<start>_<end>``
(6-digit iterations, end-exclusive), then the chain state to ``d/state``,
overwritten.  The draw sources are the port's counterpart of the
reference's ``rng_key`` state leaf: their generators' states are saved
beside the chain state, in the same write.  ``run(..., resume=True)``
restores both and continues bit-identically: the restore's skeleton is the
kernel's own init on throwaway draw sources (its evaluations and reads are
not counted in ``stats``).  One chain (under either chain method), a
lockstep batch and an ensemble checkpoint; ``"sequential"`` with more
than one chain raises.  ``chain_method="parallel"`` (chains over several
cards), meshes, telemetry and convergence monitoring wait for later
slices.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ...distributed import checkpoint as ckpt
from ..errors import pending
from .diagnostics import print_summary
from .hmc import resolve_device
from .hmc_util import GeneratorDraws

_SAMPLES_DIR_RE = re.compile(r"^samples_(\d+)_(\d+)$")


def _to_device(value, device):
    """Model arguments on ``device``: tensors moved, numpy arrays converted
    (dtype kept), containers walked, anything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value).to(device)
    if isinstance(value, (tuple, list)):
        return type(value)(_to_device(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    return value


def _stack(values, dim=0):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values, dim)
    return torch.as_tensor(np.stack(values, dim))


def _rows_to_dict(rows, dim=0):
    """Per-draw output dicts -> one dict of draws stacked along ``dim``."""
    return {k: _stack([row[k] for row in rows], dim) for k in rows[0]} \
        if rows else {}


def _join(parts, device, dim):
    """Chunk dicts of draws on ``device``, joined along ``dim``."""
    if not parts:
        return {}
    if len(parts) == 1:
        return {k: v.to(device) for k, v in parts[0].items()}
    return {k: torch.cat([p[k].to(device) for p in parts], dim)
            for k in parts[0]}


def _state_tree(state, draws):
    """What ``state/`` holds: the chain state and every draw source's
    generator state, in one write."""
    return {"chain_state": state,
            "draws": [d.generator.get_state() for d in draws]}


def _chunk_skeleton(directory):
    """A chunk of draws' restore skeleton, read from its manifest (the
    draws are a flat dict of host tensors)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {k: torch.from_numpy(np.empty(m["shape"], dtype=m["dtype"]))
            for k, m in leaves.items()}


class _Program(NamedTuple):
    """One state's run: its draw sources (saved beside it), ``init(draws
    =None)`` (the program's own sources by default), ``step``, the
    leapfrogs a state counts and the chunk's rows as a dict of draws with
    the chain axis first."""
    draws: list
    init: Callable
    step: Callable
    leapfrogs: Callable
    rows: Callable


def _chain_programs(setup, draws):
    """Per-chain kernels: each chain alone, one after another."""
    def program(d):
        return _Program(
            [d], lambda ds=None: setup.init_fn((ds or [d])[0]),
            lambda state: setup.sample_fn(state, d),
            lambda state: state.num_steps,
            lambda rows: {k: v.unsqueeze(0)
                          for k, v in _rows_to_dict(rows).items()})

    return [program(d) for d in draws]


def _lockstep_program(setup, draws):
    """Per-chain kernels in lockstep: the batched state of all chains,
    each drawing from its own source."""
    return [_Program(
        draws, lambda ds=None: setup.init_batch_fn(ds or draws),
        lambda state: setup.sample_batch_fn(state, draws),
        lambda state: int(np.sum(state.num_steps)),
        lambda rows: _rows_to_dict(rows, dim=1))]


def _ensemble_program(setup, draws):
    """Cross-chain kernels: the whole ensemble in lockstep, moved by the
    shared source (the last).  A MALA/RWM proposal counts as one step (its
    state has no ``num_steps``)."""
    def init(ds=None):
        *chain_draws, shared = ds or draws
        return setup.init_fn(chain_draws, shared)

    return [_Program(
        draws, init, lambda state: setup.sample_fn(state, draws[-1]),
        lambda state: getattr(state, "num_steps", 1),
        lambda rows: _rows_to_dict(rows, dim=1))]


class MCMC:
    """``MCMC(kernel, num_warmup, num_samples).run(seed, *args, **kwargs)``.

    ``device`` defaults to the kernel's device (``"cuda"`` unless the kernel
    was built with ``device="cpu"``); model arguments are moved there.
    After ``run``, ``stats`` holds the run's counts: ``num_leapfrog`` (every
    trajectory leapfrog, warmup included, summed over the chains of a
    per-chain kernel; for ChEES the ensemble leapfrogs, each moving all
    chains, and one per MALA/RWM proposal), ``lockstep_leapfrogs`` and
    ``lockstep_efficiency`` for a lockstep run of HMC/NUTS (the leaves of
    the batch, each moving every chain still growing its tree, and
    ``num_leapfrog / (C * lockstep_leapfrogs)``; None otherwise), ``num_iterations`` (``sample_fn`` calls), ``host_syncs`` (the
    sampler's device->host reads), ``num_grad_evals`` (per-chain potential
    value-and-gradient evaluations: the leapfrogs' plus the initial-point
    and step-size searches'), ``init_grad_evals`` (those of the searches
    alone), ``setup_seconds`` (moving the arguments, tracing the model,
    building the potential), ``chain_seconds`` (every chain's init and
    transitions, ended by a device synchronize) and ``glm_prior``
    (``"slim"`` or ``"full"``: how the fused GLM potential evaluates the
    prior term, see :mod:`repro_torch.core.infer.glm`; None when the
    potential is not fused) and ``glm_prior_batch`` (``"vmap"`` or
    ``"loop"``: how its batched entry, which the ensembles call once per
    evaluation of all chains, evaluates the prior term; None when the
    potential is not fused).  ChEES adds ``trajectory_graph`` (whether its
    trajectory replays from CUDA graphs, ``core/infer/graphs.py``),
    ``graph_replays`` and ``graph_eager_bodies`` (per graph, its replays
    and the eager runs before its capture) and ``graph_capture_seconds``.
    ``resumed_at`` is the iteration a resumed run continued from (else
    None); a resumed run counts only its own transitions.  A checkpointed
    run keeps the sampling draws' divergent transitions in
    ``_divergences`` (saved in the state's ``extra`` and continued across a
    resume, as the JAX package's executor does).
    """

    def __init__(self, kernel, num_warmup: int, num_samples: int,
                 num_chains: int = 1, thinning: int = 1,
                 chain_method: str = "vectorized", device=None):
        self.kernel = kernel
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thinning = int(thinning)
        if chain_method not in ("vectorized", "sequential", "parallel"):
            raise ValueError(f"unknown chain_method {chain_method}")
        if chain_method == "parallel":
            raise pending("chain_method='parallel'", "multi-GPU")
        self.chain_method = chain_method
        kernel_device = getattr(kernel, "device", None)
        device = resolve_device(device if device is not None
                                else kernel_device or "cuda")
        if kernel_device is not None and device != kernel_device:
            raise ValueError(f"MCMC device {device} differs from the "
                             f"kernel's {kernel_device}")
        self.device = device
        self.stats = {}
        self._setup = None
        self._samples = None
        self._collected = None
        self._last_state = None

    def run(self, seed: int, *model_args, init_params=None,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            **model_kwargs):
        """Run ``num_warmup + num_samples`` transitions of every chain from
        ``seed``.  ``checkpoint_every`` cuts the iterations into chunks of
        that many (warmup and sampling apart), ``checkpoint_dir`` saves the
        state and each chunk of draws after every chunk, and ``resume=True``
        continues from the checkpoint there (see the module docstring)."""
        if resume and checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        if checkpoint_every is not None and int(checkpoint_every) < 0:
            raise ValueError("checkpoint_every must be a positive number "
                             f"of iterations, got {checkpoint_every}")
        if (checkpoint_every or checkpoint_dir) \
                and self.chain_method == "sequential" and self.num_chains > 1:
            raise ValueError(
                "checkpointing requires a batched chain_method "
                "('vectorized' or 'parallel')")
        t0 = time.perf_counter()
        model_args = _to_device(model_args, self.device)
        model_kwargs = _to_device(model_kwargs, self.device)
        setup = self.kernel.setup(torch.Generator().manual_seed(int(seed)),
                                  self.num_warmup, init_params=init_params,
                                  model_args=model_args,
                                  model_kwargs=model_kwargs)
        self._setup = setup
        if setup.cross_chain and self.chain_method == "sequential":
            raise ValueError(
                f"kernel {setup.algo!r} adapts across the chain batch; "
                "chain_method='sequential' would run each chain alone: use "
                "'vectorized'")
        t_chains = time.perf_counter()
        lockstep = setup.sample_batch_fn is not None and (
            setup.cross_chain or (self.chain_method == "vectorized"
                                  and self.num_chains > 1))
        programs = _lockstep_program if lockstep else \
            _ensemble_program if setup.cross_chain else _chain_programs
        self._divergences = 0
        self._num_leapfrog = self._iterations = 0
        chunk = int(checkpoint_every or 0) or \
            self.num_warmup + self.num_samples
        reads0, evals0, leaves0 = self._counts(setup, lockstep)
        init_evals, parts, states, resumed_at = 0, [], [], None
        for prog in programs(setup, self._draw_sources(seed, setup,
                                                       lockstep)):
            restored = None
            if resume:
                restored = self._restore_checkpoint(
                    checkpoint_dir, prog,
                    self._draw_sources(seed, setup, lockstep))
                reads0, evals0, leaves0 = self._counts(setup, lockstep)
            if restored is not None:
                state, done, chain_parts, self._divergences = restored
                resumed_at = done
            else:
                evals = setup.grad_evals.count
                state, done, chain_parts = prog.init(), 0, []
                init_evals += setup.grad_evals.count - evals
            state = self._advance(setup, prog, state, done, chunk,
                                  checkpoint_dir, chain_parts)
            states.append(state)
            parts.append(_join(chain_parts, self.device, 1))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        self._last_state = states if not lockstep else states[0]
        self._collected = _join(parts, self.device, 0)
        z = self._collected.get("z")
        self._samples = setup.constrain_fn(z) if z is not None else {}
        num_leapfrog = self._num_leapfrog
        self.stats = {"num_leapfrog": int(num_leapfrog),
                      "num_iterations": self._iterations,
                      "host_syncs": setup.host_reads.count - reads0,
                      "num_grad_evals": setup.grad_evals.count - evals0,
                      "init_grad_evals": init_evals,
                      "setup_seconds": t_chains - t0,
                      "chain_seconds": t_end - t_chains,
                      "glm_prior": getattr(setup.potential_fn, "glm_prior",
                                           None),
                      "glm_prior_batch": getattr(setup.potential_fn,
                                                 "glm_prior_batch", None),
                      "lockstep_leapfrogs": None,
                      "lockstep_efficiency": None,
                      "resumed_at": resumed_at}
        if lockstep:
            leaves = setup.sample_batch_fn.lockstep.leapfrogs - leaves0
            self.stats["lockstep_leapfrogs"] = leaves
            self.stats["lockstep_efficiency"] = (
                num_leapfrog / (self.num_chains * leaves) if leaves else None)
        self.stats.update(getattr(setup.sample_fn, "trajectory_stats",
                                  dict)())
        return self

    @staticmethod
    def _counts(setup, lockstep):
        """The setup's host reads, potential evaluations and lockstep
        leapfrogs so far: what the run's stats count from."""
        return (setup.host_reads.count, setup.grad_evals.count,
                setup.sample_batch_fn.lockstep.leapfrogs if lockstep else 0)

    def _draw_sources(self, seed, setup, lockstep):
        """Each chain's draw source (and, for a cross-chain kernel off the
        lockstep path, the shared one last), seeded from ``seed``."""
        shared = int(setup.cross_chain and not lockstep)
        seeds = np.random.SeedSequence(int(seed)).generate_state(
            self.num_chains + shared, dtype=np.uint64)
        return [GeneratorDraws(torch.Generator().manual_seed(int(s)))
                for s in seeds]

    # -- the chunked executor -------------------------------------------------

    def _advance(self, setup, prog, state, done, chunk, checkpoint_dir,
                 parts):
        """Move ``state`` from iteration ``done`` to the end in chunks of at
        most ``chunk`` iterations (warmup and sampling never share one),
        appending each sampling chunk's draws to ``parts`` and, with a
        ``checkpoint_dir``, saving after every chunk.  Chunk boundaries
        depend only on (num_warmup, num_samples, chunk, done), so a resumed
        run issues the uninterrupted run's transitions."""
        total = self.num_warmup + self.num_samples
        while done < total:
            if done < self.num_warmup:
                n = min(chunk, self.num_warmup - done)
            else:
                n = min(chunk, total - done)
            rows = []
            for it in range(done, done + n):
                state = prog.step(state)
                self._num_leapfrog += prog.leapfrogs(state)
                if it >= self.num_warmup:
                    rows.append(setup.collect_fn(state))
            self._iterations += n
            out = prog.rows(rows) if rows else None
            if out is not None:
                parts.append(out)
            start, done = done, done + n
            if checkpoint_dir is not None:
                if out is not None and "diverging" in out:
                    self._divergences += int(out["diverging"].sum())
                self._save_checkpoint(checkpoint_dir, state, prog.draws,
                                      done, chunk=out, start=start)
        return state

    # -- checkpoint/resume ----------------------------------------------------
    # Layout under checkpoint_dir (the JAX package's):
    #   state/                     the chain state and the draw sources'
    #                              generator states, overwritten per chunk
    #   samples_<start>_<end>/     one directory per completed sampling
    #                              chunk (iterations, end-exclusive),
    #                              written once, before the chunk's state
    # The state's step advances only after the chunk's draws are on disk; a
    # samples directory orphaned by a kill between the two writes is
    # removed and written again, from the same draws, after the resume.

    def _save_checkpoint(self, directory, state, draws, done, chunk=None,
                         start=None):
        """After a chunk: its draws (a sampling chunk's, iterations
        ``start`` to ``done``), then the state at ``done``."""
        os.makedirs(directory, exist_ok=True)
        if chunk is not None:
            # orphans at or after this start (from a kill, or a resume with
            # another checkpoint_every) go: the chunks on disk stay
            # contiguous and do not overlap
            for name in os.listdir(directory):
                m = _SAMPLES_DIR_RE.match(name)
                if m and int(m.group(1)) >= start:
                    shutil.rmtree(os.path.join(directory, name))
            ckpt.save(chunk, os.path.join(
                directory, f"samples_{start:06d}_{done:06d}"), step=done)
        extra = {"num_warmup": self.num_warmup,
                 "num_samples": self.num_samples,
                 "num_chains": self.num_chains,
                 "chain_method": self.chain_method,
                 "mesh_shape": None,
                 "num_devices": (torch.cuda.device_count()
                                 if torch.cuda.is_available() else 1),
                 "divergences": int(self._divergences)}
        ckpt.save(_state_tree(state, draws),
                  os.path.join(directory, "state"), step=done, extra=extra)

    def _restore_checkpoint(self, directory, prog, skeleton_draws):
        """``(state, done, parts, divergences)`` from ``directory``, the
        program's draw sources set to their saved states; None when there
        is no checkpoint yet."""
        state_dir = os.path.join(directory, "state")
        done = ckpt.latest_step(state_dir)
        if done is None:
            return None
        with open(os.path.join(state_dir, "manifest.json")) as f:
            extra = json.load(f)["extra"]
        for field in ("num_warmup", "num_samples", "num_chains"):
            if extra.get(field) != getattr(self, field):
                raise ValueError(
                    f"checkpoint at {directory} was written by a run with "
                    f"{field}={extra.get(field)}, this MCMC has "
                    f"{getattr(self, field)}")
        # the skeleton: the kernel's own init on throwaway draw sources
        skeleton = prog.init(skeleton_draws)
        tree, _, _ = ckpt.restore(_state_tree(skeleton, prog.draws),
                                  state_dir)
        for source, saved in zip(prog.draws, tree["draws"]):
            source.generator.set_state(saved)

        ranges = []
        for name in os.listdir(directory):
            m = _SAMPLES_DIR_RE.match(name)
            if m and int(m.group(2)) <= done:
                ranges.append((int(m.group(1)), int(m.group(2))))
        ranges.sort()
        expected_start, parts = self.num_warmup, []
        for start, end in ranges:
            if start != expected_start:
                raise ValueError(
                    f"checkpoint at {directory} is missing the sample chunk "
                    f"starting at iteration {expected_start}")
            chunk_dir = os.path.join(directory,
                                     f"samples_{start:06d}_{end:06d}")
            parts.append(ckpt.restore(_chunk_skeleton(chunk_dir),
                                      chunk_dir)[0])
            expected_start = end
        if expected_start != max(done, self.num_warmup):
            raise ValueError(
                f"checkpoint at {directory} is missing sample chunks "
                f"covering iterations {expected_start}..{done}")
        divergences = int(extra.get("divergences", 0))
        return tree["chain_state"], done, parts, divergences

    def get_samples(self, group_by_chain: bool = False):
        """Constrained-space draws by site: ``(chains, samples, ...)`` when
        grouped, else ``(chains * samples, ...)``; tensors on the device."""
        samples = {k: v[:, ::self.thinning] for k, v in self._samples.items()}
        if group_by_chain:
            return samples
        return {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in samples.items()}

    def get_extra_fields(self, group_by_chain: bool = False):
        extra = {k: v[:, ::self.thinning] for k, v in self._collected.items()
                 if k != "z"}
        if group_by_chain:
            return extra
        return {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in extra.items()}

    @property
    def kernel_setup(self):
        """The :class:`KernelSetup` the last ``run`` built."""
        return self._setup

    @property
    def last_state(self):
        """The final state: one batched state (leaves lead with the chain
        axis) for a lockstep run, a list of the one ensemble state for
        ChEES/MALA/RWM, and the list of each chain's state, in chain order, for a
        sequential run."""
        return self._last_state

    def print_summary(self):
        return print_summary({k: v.detach().cpu().numpy() for k, v in
                              self.get_samples(group_by_chain=True).items()})
