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
than one chain raises.

``chain_method="parallel"`` runs the same programs over the ranks of a
``torch.distributed`` mesh (``launch.mesh.make_inference_mesh``:
``mesh_shape=None`` the 1-D ``("chains",)`` mesh, ``(Sc, Sd)`` the 2-D
``("chains", "data")`` one; one rank is one device, and with no process
group one rank in this process), and gives every rank the draws, state and
checkpoint of the one-process ``"vectorized"`` run, byte for byte:

- per-chain kernels (HMC, NUTS, also with ``cross_chain_adapt``): chain
  rank ``r`` runs the lockstep program on chains ``r C/Sc`` to ``(r + 1)
  C/Sc - 1``, with those chains' draw sources (seeded as in a vectorized
  run); each chain draws and computes what it would alone.  The pooled
  mass matrix gathers the chains' Welford rows over the chains dim and
  pools them in ``chain_sum``'s order;
- cross-chain kernels (ChEES, MALA, RWM): every rank holds the whole
  ensemble and moves it, and the ensemble's batched potential is split
  over the chains dim (each rank evaluates its rows, then they are
  gathered in rank order), so every cross-chain fold sees all C rows;
- a data-sharded potential (``data_shards``, ``KernelSetup.data_axis``):
  on a 2-D mesh each data rank holds its rows and evaluates its shards,
  gathered over the data dim before the fold (``core/infer/glm.py``).

Each chunk's draws are gathered over the chains dim, so ``get_samples()``
and ``last_state`` are the whole run's on every rank.  Rank 0 writes the
checkpoint in the logical layout of a one-process run, then every rank
of the mesh passes a barrier; the checkpoint resumes under any mesh, or
``"vectorized"`` in one process (``RPL301`` when the chain dim does not
divide the chains, ``RPL303`` when the data dim does not divide
``data_shards``).  A rank outside the mesh takes no chains.

Observability, as in the JAX package's executor (:mod:`repro_torch.obs`):
``MCMC(..., progress=True)`` prints one line a chunk,
``MCMC(..., telemetry=obs.Telemetry(...))`` evaluates the kernel's
``metrics_fn`` after every transition, times the phases (spans ``setup``,
``init`` or ``resume_restore``, ``warmup_chunk``/``sample_chunk``,
``checkpoint_write``), writes events, a run manifest and the divergence
forensics, and ``run(..., until=obs.Converged(...))`` stops between chunks
once the streaming split R-hat/ESS thresholds hold (the chunk is then
``checkpoint_every``, else ``until.check_every``; the draw budget
``until.max_samples``).  None of it changes a bit of the draws: metrics
and the gate only read what the chunk produced.  Each chunk drains
everything they need from the device (the metric series, the divergence
mask, the gate's draws) in **one** read through ``setup.host_reads``, which
the chunk span's close rides, so ``stats["host_syncs"]`` shows the cost:
at most one more a chunk (one more for a chunk that diverged, with
forensics on).  With ``telemetry=None``, ``progress=False`` and
``until=None`` the executor runs exactly the loop it runs without them.
Under ``"parallel"`` every rank computes its chains' metric series and
gathers them in rank order (the draws' order) for the chunk's read, so
every rank buffers the whole run's series and takes the gate's decision
from the same gathered draws; rank 0 alone writes the events, the manifest
(its session records ``mesh_shape`` and the rank count) and the forensics.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import time
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map

from ...distributed import checkpoint as ckpt
from ...distributed import sharding
from ...kernels import _build
from ...obs.metrics import host_tree, stack_rows
from ..errors import SHARDS_NOT_DIVISIBLE, ReproValueError
from .diagnostics import print_summary
from .hmc import resolve_device
from .hmc_util import GeneratorDraws

_SAMPLES_DIR_RE = re.compile(r"^samples_(\d+)_(\d+)$")


def _to_device(value, device):
    """Model arguments on ``device``: tensors moved, numpy arrays converted
    (dtype kept), containers walked, meta tensors (abstract arguments) and
    anything else as it is."""
    def move(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if isinstance(leaf, torch.Tensor) and not leaf.is_meta:
            return leaf.to(device)
        return leaf
    return tree_map(move, value)


def _same_leaves(a, b) -> bool:
    """The same arguments: tensors and arrays the same objects, containers
    alike, anything else equal."""
    (leaves_a, spec_a), (leaves_b, spec_b) = tree_flatten(a), tree_flatten(b)
    arrays = (torch.Tensor, np.ndarray)
    return spec_a == spec_b and all(
        x is y if isinstance(x, arrays) or isinstance(y, arrays)
        else type(x) is type(y) and x == y
        for x, y in zip(leaves_a, leaves_b))


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


def _state_tree(state, generator_states):
    """What ``state/`` holds: the chain state and every draw source's
    generator state, in one write."""
    return {"chain_state": state, "draws": list(generator_states)}


class _ChainSplit(NamedTuple):
    """A chain rank's block of a ``"parallel"`` lockstep run: chains
    ``start`` to ``stop - 1`` of the run, gathered over ``group``."""
    group: object
    start: int
    stop: int


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
    leapfrogs a state counts, the chunk's rows as a dict of draws with
    the chain axis first, and its metric rows as a dict of series (chains,
    draws), pooled ones (draws,)."""
    draws: list
    init: Callable
    step: Callable
    leapfrogs: Callable
    rows: Callable
    metrics: Callable = stack_rows


def _chain_programs(setup, draws):
    """Per-chain kernels: each chain alone, one after another."""
    def program(d):
        return _Program(
            [d], lambda ds=None: setup.init_fn((ds or [d])[0]),
            lambda state: setup.sample_fn(state, d),
            lambda state: state.num_steps,
            lambda rows: {k: v.unsqueeze(0)
                          for k, v in _rows_to_dict(rows).items()},
            lambda rows: {k: v[None] for k, v in stack_rows(rows).items()})

    return [program(d) for d in draws]


def _lockstep_program(setup, draws):
    """Per-chain kernels in lockstep: the batched state of all chains,
    each drawing from its own source."""
    return [_Program(
        draws, lambda ds=None: setup.init_batch_fn(ds or draws),
        lambda state: setup.sample_batch_fn(state, draws),
        lambda state: int(np.sum(state.num_steps)),
        lambda rows: _rows_to_dict(rows, dim=1))]


def _one_time_work(setup):
    """``(kernel libraries loaded, CUDA graphs captured)`` so far: the
    one-time device work that makes a chunk span ``program_cold``."""
    stats = getattr(setup.sample_fn, "trajectory_stats", None)
    captures = sum(stats()["graph_eager_bodies"].values()) if stats else 0
    return _build.loads(), captures


def _moments(z):
    """Per-dim mean and M2 over the chains and draws of a (C, k, D) chunk
    of draws, in float64 where they lie."""
    flat = z.reshape(-1, z.shape[-1]).to(torch.float64)
    mean = flat.mean(0)
    return mean, ((flat - mean) ** 2).sum(0)


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
    ``progress`` and ``telemetry`` (an :class:`repro_torch.obs.Telemetry`)
    observe the run (see the module docstring).  ``validate=True`` lints
    the kernel's model (:func:`repro_torch.lint.lint_model`) on the moved
    arguments before the first run's setup and again only when the model or
    its arguments change: errors raise with their ``RPL`` code, warnings
    surface as warnings, and the draws are those of ``validate=False``.
    After ``run``, ``stats`` holds the run's counts: ``num_leapfrog`` (every
    trajectory leapfrog, warmup included, summed over the chains of a
    per-chain kernel; for ChEES the ensemble leapfrogs, each moving all
    chains, and one per MALA/RWM proposal), ``lockstep_leapfrogs`` and
    ``lockstep_efficiency`` for a lockstep run of HMC/NUTS (the leaves of
    the batch, each moving every chain still growing its tree, and
    ``num_leapfrog / (C * lockstep_leapfrogs)``; None otherwise), ``num_iterations`` (``sample_fn`` calls), ``host_syncs`` (the
    sampler's device->host reads, and the executor's drains when the run
    is observed), ``num_grad_evals`` (per-chain potential
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
    or observed run keeps the sampling draws' divergent transitions in
    ``_divergences`` (saved in the state's ``extra`` and continued across a
    resume, as the JAX package's executor does); a gated run's
    :class:`~repro_torch.obs.ConvergenceMonitor` is ``monitor``.
    """

    def __init__(self, kernel, num_warmup: int, num_samples: int,
                 num_chains: int = 1, thinning: int = 1,
                 chain_method: str = "vectorized", progress: bool = False,
                 device=None, telemetry=None, mesh_shape=None,
                 validate: bool = False):
        self.kernel = kernel
        # validate=True lints the kernel's model once per fresh setup: on
        # the first run and whenever the model or its arguments change (a
        # warm re-run on the same ones does not lint again)
        self.validate = bool(validate)
        self._validated = None   # (model, arguments) last linted clean
        self.num_warmup = int(num_warmup)
        self.num_samples = int(num_samples)
        self.num_chains = int(num_chains)
        self.thinning = int(thinning)
        if chain_method not in ("vectorized", "sequential", "parallel"):
            raise ValueError(f"unknown chain_method {chain_method}")
        self.chain_method = chain_method
        # the (chains, data) mesh of chain_method="parallel"; None keeps the
        # 1-D chains mesh
        if mesh_shape is not None:
            if chain_method != "parallel":
                raise ValueError("mesh_shape is only meaningful with "
                                 "chain_method='parallel'")
            mesh_shape = tuple(int(v) for v in mesh_shape)
            if len(mesh_shape) != 2:
                raise ValueError(f"mesh_shape must be a (chains, data) pair, "
                                 f"got {mesh_shape}")
        self.mesh_shape = mesh_shape
        self._mesh = None
        kernel_device = getattr(kernel, "device", None)
        device = resolve_device(device if device is not None
                                else kernel_device or "cuda")
        if kernel_device is not None and device != kernel_device:
            raise ValueError(f"MCMC device {device} differs from the "
                             f"kernel's {kernel_device}")
        self.device = device
        self.progress = bool(progress)
        self.telemetry = telemetry
        self.monitor = None      # the gated run's ConvergenceMonitor
        self._until = None
        self._reporter = None    # the chunk reporter, made at first use
        self._divergences = 0
        self.stats = {}
        self._setup = None
        self._samples = None
        self._collected = None
        self._last_state = None

    def _validate_model(self, given, model_args, model_kwargs):
        """Lint the kernel's model on the moved arguments before its setup
        is built: errors raise with their ``RPL`` code, warnings surface as
        warnings.  Skipped when the same model was linted clean on the same
        arguments (``given``, as the caller passed them), so a warm re-run
        does not trace the model again for the linter.  The linter draws
        from a generator of its own: the run's draws are those of
        ``validate=False``."""
        model = getattr(self.kernel, "model", None)
        if model is None:
            return  # potential_fn-only kernels have no model to lint
        if self._validated is not None and self._validated[0] is model \
                and _same_leaves(self._validated[1], given):
            return
        from ..lint import lint_model
        result = lint_model(model, model_args, model_kwargs,
                           device=self.device)
        for finding in result.warnings:
            warnings.warn(str(finding), stacklevel=4)
        result.raise_if_errors()
        self._validated = (model, given)

    def run(self, seed: int, *model_args, init_params=None,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            until=None, **model_kwargs):
        """Run ``num_warmup + num_samples`` transitions of every chain from
        ``seed``.  ``checkpoint_every`` cuts the iterations into chunks of
        that many (warmup and sampling apart), ``checkpoint_dir`` saves the
        state and each chunk of draws after every chunk, and ``resume=True``
        continues from the checkpoint there; ``until=obs.Converged(...)``
        stops between chunks once its thresholds hold (see the module
        docstring)."""
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
        self._gate(until)
        tele = self.telemetry
        if tele is not None and self.chain_method == "sequential":
            raise ValueError(
                "telemetry requires a batched chain_method ('vectorized' "
                "or 'parallel'): sequential runs re-enter the executor per "
                "chain, so there is no single chunk stream to instrument")
        mesh = self._inference_mesh() if self.chain_method == "parallel" \
            else None
        if mesh is not None and mesh.get_coordinate() is None:
            return self._idle()
        if tele is not None:
            # open the sink and the manifest before any span can fire; the
            # setup-derived fields land via commit_run_config below
            tele.begin_run(
                {"algo": type(self.kernel).__name__,
                 "kernel_setup_hash": "",
                 "num_warmup": self.num_warmup,
                 "num_samples": self.num_samples,
                 "num_chains": self.num_chains,
                 "chain_method": self.chain_method,
                 "mesh_shape": self._mesh_fields()[0],
                 "thinning": self.thinning,
                 "until": (None if until is None else
                           {"max_rhat": until.max_rhat,
                            "min_ess": until.min_ess,
                            "max_samples": until.max_samples,
                            "check_every": until.check_every,
                            "batch_size": until.batch_size})},
                default_dir=checkpoint_dir, resume=resume,
                mesh_shape=self._mesh_fields()[0],
                device_count=(mesh.size() if mesh is not None else None),
                writer=mesh is None or dist.get_rank() == 0)
        t0 = time.perf_counter()
        with self._span("setup"):
            given = (model_args, model_kwargs)
            model_args = _to_device(model_args, self.device)
            model_kwargs = _to_device(model_kwargs, self.device)
            if self.validate:
                self._validate_model(given, model_args, model_kwargs)
            setup = self.kernel.setup(
                torch.Generator().manual_seed(int(seed)), self.num_warmup,
                init_params=init_params, model_args=model_args,
                model_kwargs=model_kwargs)
        self._setup = setup
        if tele is not None:
            tele.commit_run_config(
                algo=setup.algo,
                kernel_setup_hash=f"{hash(setup) & ((1 << 64) - 1):016x}")
        if setup.cross_chain and self.chain_method == "sequential":
            raise ValueError(
                f"kernel {setup.algo!r} adapts across the chain batch; "
                "chain_method='sequential' would run each chain alone: use "
                "'vectorized' or 'parallel'")
        if mesh is not None:
            self._check_data_axis(setup, mesh)
        if self.progress:
            if tele is not None:
                self._reporter = tele.reporter
            elif self._reporter is None:
                from ...obs.report import LiveReporter
                self._reporter = LiveReporter()
            self._reporter.start(self.num_warmup + self.num_samples)
        t_chains = time.perf_counter()
        batched = self.chain_method == "parallel" or (
            self.chain_method == "vectorized" and self.num_chains > 1)
        lockstep = setup.sample_batch_fn is not None and (
            setup.cross_chain or batched)
        programs = _lockstep_program if lockstep else \
            _ensemble_program if setup.cross_chain else _chain_programs
        split = None
        if mesh is not None and lockstep:
            split = _ChainSplit(mesh.get_group(sharding.CHAIN_AXIS),
                                *sharding.local_block(
                                    self.num_chains, mesh,
                                    sharding.chain_placements(mesh)))
        with self._mesh_context(mesh, lockstep):
            states, parts, init_evals, resumed_at, counts0 = self._chains(
                seed, setup, programs, lockstep, split,
                checkpoint_every=checkpoint_every,
                checkpoint_dir=checkpoint_dir, resume=resume)
        reads0, evals0, leaves0 = counts0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        self._last_state = states if not lockstep else states[0]
        self._collected = _join(parts, self.device, 0)
        z = self._collected.get("z")
        self._samples = setup.constrain_fn(z) if z is not None else {}
        drawn = int(z.shape[1]) if z is not None else 0
        if self.monitor is not None and self.monitor.decision is None:
            # the gate never fired: the draw budget ran out unconverged
            self.monitor.exhausted(drawn)
        if tele is not None:
            self._finish_telemetry(setup, drawn)
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
            chains = self.num_chains if split is None \
                else split.stop - split.start
            leaves = setup.sample_batch_fn.lockstep.leapfrogs - leaves0
            self.stats["lockstep_leapfrogs"] = leaves
            self.stats["lockstep_efficiency"] = (
                num_leapfrog / (chains * leaves) if leaves else None)
        self.stats.update(getattr(setup.sample_fn, "trajectory_stats",
                                  dict)())
        return self

    def _chains(self, seed, setup, programs, lockstep, split, *,
                checkpoint_every, checkpoint_dir, resume):
        """Every program's init (or restore) and chunks: ``(final states,
        each program's draws, init evaluations, resumed_at, the counts the
        run's stats start from)``."""
        tele = self.telemetry
        self._divergences = 0
        self._num_leapfrog = self._iterations = 0
        if checkpoint_every:
            chunk = int(checkpoint_every)
        elif self.monitor is not None:
            chunk = int(self.monitor.until.check_every)
        else:
            chunk = self.num_warmup + self._target_samples()
        counts0 = self._counts(setup, lockstep)
        init_evals, parts, states, resumed_at = 0, [], [], None
        draws = self._draw_sources(seed, setup, lockstep)
        if split is not None:
            draws = draws[split.start:split.stop]
        for prog in programs(setup, draws):
            restored = None
            if resume:
                with self._span("resume_restore"):
                    restored = self._restore_checkpoint(
                        checkpoint_dir, prog,
                        self._draw_sources(seed, setup, lockstep), split)
                counts0 = self._counts(setup, lockstep)
            if restored is not None:
                state, done, chain_parts, self._divergences, extra = restored
                resumed_at = done
                self._resume_monitor(extra, chain_parts)
                if tele is not None:
                    tele.set_resumed_at(done)
                    tele.record_divergences(self._divergences)
                    for part in chain_parts if tele.forensics else ():
                        tele.forensics.fold_moments(
                            part["z"].shape[0] * part["z"].shape[1],
                            *_moments(part["z"]))
            else:
                with self._span("init"):
                    evals = setup.grad_evals.count
                    state, done, chain_parts = prog.init(), 0, []
                    init_evals += setup.grad_evals.count - evals
            if tele is not None and tele.metrics \
                    and setup.metrics_fn is not None:
                self._check_metrics_contract(
                    setup, state, lockstep, self.num_chains if split is None
                    else split.stop - split.start)
            state = self._advance(setup, prog, state, done, chunk,
                                  checkpoint_dir, chain_parts, split)
            if split is not None:
                state = sharding.gather_tree(state, split.group)
            states.append(state)
            parts.append(_join(chain_parts, self.device, 1))
        return states, parts, init_evals, resumed_at, counts0

    # -- the mesh (chain_method="parallel") -----------------------------------

    def _inference_mesh(self):
        """The run's mesh (built once; ``RPL301`` when it does not fit)."""
        if self._mesh is None:
            from ...launch.mesh import make_inference_mesh
            self._mesh = make_inference_mesh(self.num_chains, self.mesh_shape,
                                             devices=self.device.type)
        return self._mesh

    def _mesh_fields(self):
        """``(mesh_shape, num_devices)`` of the run as its records give
        them: the mesh's shape and rank count under ``"parallel"``, else
        ``(None, 1)``."""
        if self.chain_method != "parallel":
            return None, 1
        mesh = self._inference_mesh()
        return list(mesh.shape), mesh.size()

    def _mesh_context(self, mesh, lockstep):
        """The mesh as the potentials see it during the run: data shards
        over its data dim, and, for a cross-chain kernel, the ensemble's
        rows over its chains dim."""
        if mesh is None:
            return contextlib.nullcontext()
        return sharding.use_inference_mesh(mesh, sharding.DATA_AXIS,
                                           ensemble=not lockstep)

    def _check_data_axis(self, setup, mesh):
        """``RPL303`` before the first transition when the mesh's data dim
        does not divide the potential's ``data_shards``."""
        shards = getattr(setup.potential_fn, "data_shards", None)
        if setup.data_axis is None or shards is None \
                or setup.data_axis not in (mesh.mesh_dim_names or ()):
            return
        size = sharding.dim_size(mesh, setup.data_axis)
        if shards % size:
            raise ReproValueError(
                f"potential has data_shards={shards} but the mesh data axis "
                f"has {size} devices; pick data_shards as a multiple of the "
                "data-axis size.", code=SHARDS_NOT_DIVISIBLE)

    def _idle(self):
        """A rank outside the mesh: no chains, no draws."""
        self._samples, self._collected, self._last_state = {}, {}, None
        self.stats = {}
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

    # -- observability --------------------------------------------------------

    def _gate(self, until):
        """Set up the convergence gate of ``run(..., until=...)``: a
        :class:`~repro_torch.obs.Converged` (else TypeError), a batched
        chain method (else ValueError) and a geometry that can fire (else
        RPL403), all before the first transition."""
        self._until = until
        self.monitor = None
        if until is None:
            return
        from ...lint_rules.obs_rules import verify_until
        from ...obs.monitor import Converged, ConvergenceMonitor
        if not isinstance(until, Converged):
            raise TypeError(f"until must be an obs.Converged spec, got "
                            f"{type(until).__name__}")
        if self.chain_method == "sequential":
            raise ValueError(
                "convergence gating requires a batched chain_method "
                "('vectorized' or 'parallel'): sequential runs finish "
                "one chain before the next starts, so cross-chain "
                "R-hat cannot be streamed mid-run")
        verify_until(until, num_samples=self.num_samples,
                     num_chains=self.num_chains).raise_if_errors()
        self.monitor = ConvergenceMonitor(until)

    def _target_samples(self) -> int:
        """Post-warmup draw budget: ``until.max_samples`` when a gated run
        sets one (it may exceed ``num_samples``), else ``num_samples``."""
        if self._until is not None and self._until.max_samples is not None:
            return int(self._until.max_samples)
        return self.num_samples

    def _span(self, name, **attrs):
        """Telemetry phase span, or an inert context when telemetry is off
        (yields a mutable attr dict either way)."""
        if self.telemetry is None:
            return contextlib.nullcontext(dict(attrs))
        return self.telemetry.span(name, **attrs)

    def _check_metrics_contract(self, setup, state, lockstep, chains):
        """RPL401 and RPL402 on the run's own initial state (``chains`` of
        them: a chain rank's block under ``"parallel"``), before the first
        transition: the runtime twin of
        :func:`repro_torch.lint_rules.obs_rules.verify_metrics_fn`.  A
        clean metrics_fn costs no read."""
        from ...lint_rules.obs_rules import check_metrics_state
        from ..lint import LintResult
        LintResult(check_metrics_state(
            setup, state, chains,
            batched=lockstep and not setup.cross_chain)).raise_if_errors()

    def _resume_monitor(self, extra, parts):
        """Re-hydrate a gated run's accumulators from the checkpoint
        ``extra``, or, for a checkpoint of an ungated run, fold its
        restored draws (host tensors): both land on the same state, since
        folds depend on the draw stream only."""
        if self.monitor is None:
            return
        saved = extra.get("monitor")
        if saved is not None:
            self.monitor.load_state_dict(saved)
        elif parts:
            self.monitor.fold(np.concatenate([p["z"].numpy() for p in parts],
                                             axis=1))

    def _drain(self, setup, prog, metric_rows, out, count_div, split=None):
        """Everything the chunk's observers need from the device, in one
        read through ``setup.host_reads``: the metric series (a chain
        rank's gathered over ``split``'s ranks in rank order, the draws'
        order), the divergence mask, the gate's draws, with forensics on
        the draws' per-dim moments (the baseline), and, for a progress line
        without metrics, the step size and accept prob.  With telemetry
        on, a chunk that had nothing on the device to read still ends in
        one counted synchronize, so its span closes on finished device
        work.  Returns ``(host metrics or None, host fields of out)``."""
        tele = self.telemetry
        forens = tele.forensics if tele is not None else None
        tree, fields = {}, []
        if metric_rows:
            series = prog.metrics(metric_rows)
            if split is not None:
                series = sharding.gather_tree(series, split.group)
            tree.update({("m", k): v for k, v in series.items()})
        if out is not None:
            if forens is not None:
                tree[("b", "mean")], tree[("b", "m2")] = _moments(out["z"])
            if count_div and "diverging" in out:
                fields.append("diverging")
            if self.monitor is not None:
                fields.append("z")
            if self.progress and not metric_rows:
                fields += [k for k in ("step_size", "accept_prob")
                           if k in out]
        tree.update({("o", k): out[k] for k in fields})
        reads = setup.host_reads
        before = reads.count
        host = host_tree(tree, reads, self.device)
        if tele is not None and reads.count == before:
            reads.sync(self.device)
        if ("b", "mean") in host:
            forens.fold_moments(out["z"].shape[0] * out["z"].shape[1],
                                host[("b", "mean")], host[("b", "m2")])
        metrics = {k: v for (kind, k), v in host.items() if kind == "m"} \
            if metric_rows else None
        return metrics, {k: v for (kind, k), v in host.items()
                         if kind == "o"}

    def _finish_telemetry(self, setup, drawn):
        """The run's final block: the divergence total, the forensics
        baseline (from the chunks' moments), the gate's decision and the
        metrics summary."""
        tele = self.telemetry
        tele.record_divergences(self._divergences)
        forens = tele.forensics
        if forens is not None and forens.total > 0:
            forens.set_baseline_from_moments()
        final = {"done": self.num_warmup + drawn,
                 "divergences": int(self._divergences)}
        if self.monitor is not None:
            final["convergence"] = self.monitor.decision
        if tele.metrics and setup.metrics_fn is not None:
            final["metrics"] = tele.buffer.summary("sample")
        tele.finish_run(final)

    # -- the chunked executor -------------------------------------------------

    def _advance(self, setup, prog, state, done, chunk, checkpoint_dir,
                 parts, split=None):
        """Move ``state`` from iteration ``done`` to the end in chunks of at
        most ``chunk`` iterations (warmup and sampling never share one),
        appending each sampling chunk's draws (gathered over ``split``'s
        chain ranks) to ``parts`` and, with a ``checkpoint_dir``, saving
        after every chunk.  Chunk boundaries
        depend only on (num_warmup, num_samples, chunk, done), so a resumed
        run issues the uninterrupted run's transitions.

        An observed run (telemetry, progress or a gate) drains each chunk
        once (:meth:`_drain`) and acts on the host copies: the metric
        series, the divergence counter and forensics, the gate's check and
        the progress line; nothing of it reaches the state."""
        tele = self.telemetry
        observed = tele is not None or self.progress \
            or self.monitor is not None
        want_metrics = tele is not None and tele.metrics \
            and setup.metrics_fn is not None
        count_div = self.progress or tele is not None \
            or checkpoint_dir is not None
        forens = tele.forensics if tele is not None else None
        total = self.num_warmup + self._target_samples()
        while done < total:
            # a resumed gated run whose decision was already "converged"
            # (killed after the decisive chunk's state write) draws no more
            if self.monitor is not None and self.monitor.decision \
                    and self.monitor.decision.get("reason") == "converged":
                break
            if done < self.num_warmup:
                phase, n = "warmup", min(chunk, self.num_warmup - done)
            else:
                phase, n = "sample", min(chunk, total - done)
            rows, metric_rows = [], []
            work0 = _one_time_work(setup) if tele is not None else None
            with self._span(f"{phase}_chunk", phase=phase, start=done,
                            end=done + n) as attrs:
                for it in range(done, done + n):
                    state = prog.step(state)
                    self._num_leapfrog += prog.leapfrogs(state)
                    if want_metrics:
                        metric_rows.append(setup.metrics_fn(state))
                    if it >= self.num_warmup:
                        rows.append(setup.collect_fn(state))
                self._iterations += n
                out = prog.rows(rows) if rows else None
                if out is not None and split is not None:
                    out = sharding.gather_tree(out, split.group)
                if out is not None:
                    parts.append(out)
                if observed:
                    metrics, fields = self._drain(setup, prog, metric_rows,
                                                  out, count_div, split)
                if tele is not None:
                    builds, captures = (b - a for a, b in zip(
                        work0, _one_time_work(setup)))
                    tele.counter("kernel_builds", builds)
                    tele.counter("graph_captures", captures)
                    attrs["program_cold"] = bool(builds or captures)
            start, done = done, done + n
            stop = False
            if observed:
                stop = self._chunk_boundary(setup, phase, start, done, total,
                                            out, metrics, fields, forens)
            if checkpoint_dir is not None:
                if not observed and out is not None and "diverging" in out:
                    self._divergences += int(out["diverging"].sum())
                with self._span("checkpoint_write", step=done):
                    self._save_checkpoint(checkpoint_dir, state, prog.draws,
                                          done, chunk=out, start=start,
                                          split=split)
            if stop:
                break
        return state

    def _chunk_boundary(self, setup, phase, start, done, total, out,
                        metrics, fields, forens):
        """An observed chunk's host side: buffer its metrics and emit its
        event, count its divergences (forensics gathers the divergent rows:
        one more read), fold its draws into the gate and check it, print
        the progress line.  Returns whether the gate stops the run."""
        tele = self.telemetry
        host_met = tele.drain_chunk(phase, start, done, metrics) \
            if tele is not None else None
        delta_div = 0
        if "diverging" in fields:
            mask = fields["diverging"]
            delta_div = int(np.sum(mask))
            if forens is not None and delta_div:
                forens.fold(start, out, mask, phase=phase,
                            reads=setup.host_reads)
            self._divergences += delta_div
            if tele is not None:
                tele.record_divergences(self._divergences)
        stop = False
        if self.monitor is not None and out is not None:
            self.monitor.fold(fields["z"])
            stop = self.monitor.check(done - self.num_warmup)
        if self.progress:
            self._reporter.chunk(
                done=done, total=total, phase=phase,
                num_chains=self.num_chains, divergences=self._divergences,
                delta_div=delta_div,
                metrics=host_met if host_met is not None else fields,
                convergence=(self.monitor.history[-1]
                             if self.monitor is not None
                             and self.monitor.history else None))
        return stop

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
                         start=None, split=None):
        """After a chunk: its draws (a sampling chunk's, iterations
        ``start`` to ``done``), then the state at ``done``.  Under
        ``"parallel"`` a chain rank's state and generators are gathered
        first, rank 0 writes the one-process run's files, and the mesh's
        ranks meet at a barrier after it."""
        generators = [d.generator.get_state() for d in draws]
        if split is not None:
            state = sharding.gather_tree(state, split.group)
            generators = list(sharding.all_gather_rows(
                torch.stack(generators), split.group))
        if self.chain_method != "parallel" or dist.get_rank() == 0:
            self._write_checkpoint(directory, state, generators, done,
                                   chunk, start)
        if self.chain_method == "parallel":
            sharding.barrier(self._inference_mesh())

    def _write_checkpoint(self, directory, state, generators, done, chunk,
                          start):
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
        mesh_shape, devices = self._mesh_fields()
        extra = {"num_warmup": self.num_warmup,
                 "num_samples": self.num_samples,
                 "num_chains": self.num_chains,
                 "chain_method": self.chain_method,
                 "mesh_shape": mesh_shape,
                 "num_devices": devices,
                 "divergences": int(self._divergences)}
        if self.monitor is not None:
            # a gated run's accumulators and decision: a resumed run
            # re-hydrates them and stops at the same iteration
            extra["monitor"] = self.monitor.state_dict()
        ckpt.save(_state_tree(state, generators),
                  os.path.join(directory, "state"), step=done, extra=extra)

    def _restore_checkpoint(self, directory, prog, skeleton_draws,
                            split=None):
        """``(state, done, parts, divergences, extra)`` from ``directory``,
        the program's draw sources set to their saved states; None when
        there is no checkpoint yet.  The checkpoint holds the whole run
        (every layout writes the logical one); a chain rank takes its
        block of it."""
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
        if split is None:
            skeleton = prog.init(skeleton_draws)
        else:
            skeleton = sharding.gather_tree(
                prog.init(skeleton_draws[split.start:split.stop]),
                split.group)
        tree, _, _ = ckpt.restore(_state_tree(
            skeleton, [d.generator.get_state() for d in skeleton_draws]),
            state_dir)
        state, saved = tree["chain_state"], tree["draws"]
        if split is not None:
            state = sharding.take_rows(state, split.start, split.stop)
            saved = saved[split.start:split.stop]
        for source, generator_state in zip(prog.draws, saved):
            source.generator.set_state(generator_state)

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
        return state, done, parts, divergences, extra

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
