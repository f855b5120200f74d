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
``chain_method="sequential"`` raises for them.  ``chain_method="parallel"``
(chains over several cards), checkpoint/resume, meshes, telemetry and
convergence monitoring wait for later slices.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..errors import pending
from .diagnostics import print_summary
from .hmc import resolve_device
from .hmc_util import GeneratorDraws


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

    def run(self, seed: int, *model_args, init_params=None, **model_kwargs):
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
        reads0 = setup.host_reads.count
        evals0 = setup.grad_evals.count
        t_chains = time.perf_counter()
        lockstep = setup.sample_batch_fn is not None and (
            setup.cross_chain or (self.chain_method == "vectorized"
                                  and self.num_chains > 1))
        shared = int(setup.cross_chain and not lockstep)
        seeds = np.random.SeedSequence(int(seed)).generate_state(
            self.num_chains + shared, dtype=np.uint64)
        draws = [GeneratorDraws(torch.Generator().manual_seed(int(s)))
                 for s in seeds]
        run_chain = self._run_lockstep if lockstep else \
            self._run_ensemble if setup.cross_chain else self._run_chains
        leaves0 = setup.sample_batch_fn.lockstep.leapfrogs if lockstep \
            else 0
        states, collected, num_leapfrog, init_evals, iterations = \
            run_chain(setup, draws)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        self._last_state = states
        self._collected = {k: v.to(self.device) for k, v in collected.items()}
        z = self._collected.get("z")
        self._samples = setup.constrain_fn(z) if z is not None else {}
        self.stats = {"num_leapfrog": int(num_leapfrog),
                      "num_iterations": iterations,
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
                      "lockstep_efficiency": None}
        if lockstep:
            leaves = setup.sample_batch_fn.lockstep.leapfrogs - leaves0
            self.stats["lockstep_leapfrogs"] = leaves
            self.stats["lockstep_efficiency"] = (
                num_leapfrog / (self.num_chains * leaves) if leaves else None)
        self.stats.update(getattr(setup.sample_fn, "trajectory_stats",
                                  dict)())
        return self

    def _run_chains(self, setup, draws):
        """Per-chain kernels: each chain alone, one after another."""
        collected, states, num_leapfrog, init_evals = [], [], 0, 0
        for chain_draws in draws:
            evals0 = setup.grad_evals.count
            state = setup.init_fn(chain_draws)
            init_evals += setup.grad_evals.count - evals0
            rows = []
            for it in range(self.num_warmup + self.num_samples):
                state = setup.sample_fn(state, chain_draws)
                num_leapfrog += state.num_steps
                if it >= self.num_warmup:
                    rows.append(setup.collect_fn(state))
            collected.append(_rows_to_dict(rows))
            states.append(state)
        collected = {k: torch.stack([c[k].to(self.device) for c in collected])
                     for k in collected[0]}
        iterations = len(draws) * (self.num_warmup + self.num_samples)
        return states, collected, num_leapfrog, init_evals, iterations

    def _run_lockstep(self, setup, draws):
        """Per-chain kernels in lockstep: the batched state of all chains,
        each drawing from its own source."""
        evals0 = setup.grad_evals.count
        state = setup.init_batch_fn(draws)
        init_evals = setup.grad_evals.count - evals0
        rows, num_leapfrog = [], 0
        for it in range(self.num_warmup + self.num_samples):
            state = setup.sample_batch_fn(state, draws)
            num_leapfrog += int(np.sum(state.num_steps))
            if it >= self.num_warmup:
                rows.append(setup.collect_fn(state))
        return (state, _rows_to_dict(rows, dim=1), num_leapfrog, init_evals,
                self.num_warmup + self.num_samples)

    def _run_ensemble(self, setup, draws):
        """Cross-chain kernels: the whole ensemble in lockstep.  A MALA/RWM
        proposal counts as one step (its state has no ``num_steps``)."""
        *chain_draws, shared = draws
        evals0 = setup.grad_evals.count
        state = setup.init_fn(chain_draws, shared)
        init_evals = setup.grad_evals.count - evals0
        rows, num_leapfrog = [], 0
        for it in range(self.num_warmup + self.num_samples):
            state = setup.sample_fn(state, shared)
            num_leapfrog += getattr(state, "num_steps", 1)
            if it >= self.num_warmup:
                rows.append(setup.collect_fn(state))
        return ([state], _rows_to_dict(rows, dim=1), num_leapfrog, init_evals,
                self.num_warmup + self.num_samples)

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
