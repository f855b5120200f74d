"""HMC and NUTS as sampler kernels (diagonal mass matrix).

:func:`hmc_setup` does the one-time work (tracing the model, building the
flat potential and the Stan-style windowed adaptation schedule) and returns
a :class:`~repro_torch.core.infer.kernel_api.KernelSetup` whose ``init_fn``
and ``sample_fn`` advance one chain.  The vectors of the chain state live on
the kernel's device; the scalars that steer it (energies, accept
probabilities, dual averaging) live on the host, so the step size is a
device scalar rewritten from the host value once per warmup transition.

:func:`flat_model_ingredients` is the model-tracing preamble every
gradient-based setup shares (this one, ChEES's and MALA/RWM's).  Dense mass
matrices and NUTS's cross-chain (pooled) adaptation wait for later slices.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..errors import NO_DEVICE, ReproRuntimeError, pending
from .hmc_util import (
    DAState,
    HostReads,
    IntegratorState,
    WelfordState,
    build_adaptation_schedule,
    build_tree,
    dual_averaging_init,
    dual_averaging_update,
    find_reasonable_step_size,
    kinetic_energy,
    momentum_sample,
    to_device,
    value_and_grad,
    velocity_verlet,
    welford_covariance,
    welford_init,
    welford_update,
    window_predicates,
)
from .kernel_api import KernelSetup
from .util import (find_valid_initial_params, initialize_model_structure,
                   prior_init, ravel)

_F32 = np.float32


class AdaptState(NamedTuple):
    step_size: torch.Tensor            # device scalar, the chain's dtype
    inverse_mass_matrix: torch.Tensor  # (D,)
    da_state: DAState
    welford: WelfordState
    window_idx: int


class HMCState(NamedTuple):
    i: int
    z: torch.Tensor                    # flat unconstrained position
    potential_energy: torch.Tensor     # device scalar
    z_grad: torch.Tensor
    energy: np.float32
    num_steps: int                     # leapfrog steps this iteration
    accept_prob: np.float32
    mean_accept_prob: np.float32
    diverging: bool
    adapt_state: AdaptState


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when it is a card this process
    does not have (entry points never fall back to the CPU silently)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ReproRuntimeError(
            "device 'cuda' was requested (the default) but torch.cuda is not "
            "available; pass device='cpu' to run on the CPU.", code=NO_DEVICE)
    return device


def _check_on_device(value, device):
    """Raise unless every tensor in ``value`` (containers walked) lies on
    ``device``."""
    if isinstance(value, torch.Tensor):
        if value.device.type != device.type or (
                device.index is not None and value.device.index is not None
                and value.device.index != device.index):
            raise ValueError(f"a model argument lies on {value.device}, the "
                             f"sampler on {device}: move the arguments there "
                             "(MCMC.run does)")
    elif isinstance(value, (tuple, list)):
        for v in value:
            _check_on_device(v, device)
    elif isinstance(value, dict):
        for v in value.values():
            _check_on_device(v, device)


def _full(value, like):
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _make_init_fn(potential_fn, prototype, reads, *, z_fixed, adapt_step_size,
                  step_size0, init_strategy):
    """Per-chain state init: initial-point search (unless ``z_fixed``),
    reasonable-step-size search, adaptation bootstrap."""
    dim = prototype.numel()

    def init_fn(draws):
        if z_fixed is not None:
            z = z_fixed
            pe, grad = value_and_grad(potential_fn)(z)
        else:
            z, pe, grad = find_valid_initial_params(
                draws, potential_fn, prototype, init_strategy=init_strategy,
                reads=reads)
        imm = torch.ones(dim, dtype=z.dtype, device=z.device)
        if adapt_step_size:
            step_size = find_reasonable_step_size(
                potential_fn, imm, z, pe, grad, draws, reads,
                init_step_size=step_size0)
        else:
            step_size = _F32(step_size0)
        adapt = AdaptState(_full(step_size, z), imm,
                           dual_averaging_init(np.log(step_size)),
                           welford_init(dim, z.dtype, z.device), 0)
        energy = _F32(reads.read(pe.reshape(1))[0])
        return HMCState(i=0, z=z, potential_energy=pe, z_grad=grad,
                        energy=energy, num_steps=0, accept_prob=_F32(0),
                        mean_accept_prob=_F32(0), diverging=False,
                        adapt_state=adapt)

    return init_fn


def _make_sample_fn(potential_fn, num_warmup, schedule, reads, *, algo,
                    trajectory_length, adapt_step_size, adapt_mass_matrix,
                    target_accept_prob, max_tree_depth):
    """The transition ``(HMCState, draws) -> HMCState``."""
    in_middle_window, window_end_is_middle = window_predicates(schedule)
    pe_and_grad, vv_update = velocity_verlet(potential_fn)

    def adapt_update(state: HMCState, accept_prob) -> AdaptState:
        adapt = state.adapt_state
        t = state.i
        da, step_size = adapt.da_state, None
        # 1) dual averaging on log step size
        if adapt_step_size:
            da = dual_averaging_update(da, _F32(target_accept_prob)
                                       - accept_prob)
            step_size = np.exp(da.x)
        imm, wf, at_end = adapt.inverse_mass_matrix, adapt.welford, False
        if adapt_mass_matrix:
            # 2) welford accumulation inside middle windows
            if in_middle_window(t):
                wf = welford_update(wf, state.z)
            # 3) at the end of a middle window: refresh the mass matrix,
            #    reset welford, restart dual averaging from the average
            at_end = window_end_is_middle(t)
            if at_end:
                imm = welford_covariance(wf)
                wf = welford_init(imm.numel(), imm.dtype, imm.device)
                if adapt_step_size:
                    step_size = np.exp(da.x_avg)
                    da = dual_averaging_init(np.log(step_size))
        # final step of warmup: freeze the averaged step size
        if adapt_step_size and t == num_warmup - 1:
            step_size = np.exp(da.x_avg)
        step_tensor = adapt.step_size if step_size is None \
            else _full(step_size, adapt.step_size)
        return AdaptState(step_tensor, imm, da, wf,
                          adapt.window_idx + int(at_end))

    def sample_fn(state: HMCState, draws) -> HMCState:
        adapt = state.adapt_state
        imm, step_size = adapt.inverse_mass_matrix, adapt.step_size
        z = state.z
        r = momentum_sample(to_device(draws.momentum(z.numel(), z.dtype),
                                      z.device), imm)
        ke = kinetic_energy(imm, r)
        vals = reads.read(torch.stack([state.potential_energy, ke,
                                       step_size]))
        energy_cur = _F32(vals[0]) + _F32(vals[1])
        start = IntegratorState(z, r, state.potential_energy, state.z_grad)
        if algo == "NUTS":
            tree = build_tree(pe_and_grad, imm, step_size, draws, start,
                              energy_cur, reads,
                              max_tree_depth=max_tree_depth)
            accept_prob = _F32(tree.sum_accept_probs
                               / max(tree.num_proposals, 1))
            z, pe, grad = (tree.z_proposal, tree.z_proposal_pe,
                           tree.z_proposal_grad)
            energy = tree.z_proposal_energy
            num_steps = tree.num_proposals
            diverging = tree.diverging
        else:
            num_steps = int(min(max(math.ceil(
                _F32(trajectory_length) / _F32(vals[2])), 1), 1024))
            nxt = start
            for _ in range(num_steps):
                nxt = vv_update(step_size, imm, nxt)
            new = reads.read(torch.stack([nxt.potential_energy,
                                          kinetic_energy(imm, nxt.r)]))
            energy_new = _F32(new[0]) + _F32(new[1])
            delta = _F32(np.inf) if np.isnan(energy_new) \
                else _F32(energy_new - energy_cur)
            accept_prob = _F32(1) if delta <= 0 else _F32(np.exp(-delta))
            if draws.accept_uniform() < accept_prob:
                z, pe, grad, energy = (nxt.z, nxt.potential_energy,
                                       nxt.z_grad, energy_new)
            else:
                pe, grad, energy = (state.potential_energy, state.z_grad,
                                    energy_cur)
            diverging = bool(delta > 1000.0)
        in_warmup = state.i < num_warmup
        new_adapt = adapt_update(state, accept_prob) if in_warmup else adapt
        i = state.i + 1
        # running mean accept prob over the post-warmup phase
        if in_warmup:
            mean_ap = accept_prob
        else:
            n_post = max(i - num_warmup, 1)
            mean_ap = _F32(state.mean_accept_prob
                           + (accept_prob - state.mean_accept_prob) / n_post)
        return HMCState(i, z, pe, grad, energy, num_steps, accept_prob,
                        mean_ap, diverging, new_adapt)

    return sample_fn


def _collect_fn(state: HMCState):
    """Per-draw outputs the executor records during the sampling phase."""
    return {
        "z": state.z,
        "potential_energy": state.potential_energy,
        "energy": state.energy,
        "num_steps": state.num_steps,
        "accept_prob": state.accept_prob,
        "diverging": state.diverging,
        "step_size": state.adapt_state.step_size,
    }


def flat_model_ingredients(generator, device, *, model=None,
                           potential_fn=None, init_params=None,
                           model_args=(), model_kwargs=None,
                           data_shards=None, init_strategy="uniform"):
    """The one-time work every gradient-based setup shares: trace the model
    (or take a raw ``potential_fn``) on ``device``, which must be there
    (raises ``RPL502`` for a card this process lacks) and where the model
    arguments must already lie.  Returns ``(potential_flat, unravel,
    constrain, prototype, z_fixed, init_strategy)``: the flat potential, the
    flat-vector closures, a flat prototype on ``device``, the flat
    ``init_params`` (None without them) and the initial-point strategy for
    :func:`find_valid_initial_params` (``"prior"`` becomes the model's
    :func:`prior_init` proposal).  ``data_shards`` waits for the multi-GPU
    slice."""
    if data_shards is not None:
        raise pending("data_shards", "multi-GPU")
    device = resolve_device(device)
    model_kwargs = model_kwargs or {}
    if model is not None:
        _check_on_device((model_args, model_kwargs), device)
        (potential_flat, unravel, transforms, constrain, _,
         prototype) = initialize_model_structure(generator, model,
                                                 model_args, model_kwargs)
        prototype = prototype.to(device)
        z_fixed = None
        if init_params is not None:
            z_fixed = ravel({k: transforms[k].inv(torch.as_tensor(v).to(device))
                             for k, v in init_params.items()})[0]
        if init_strategy == "prior":
            init_strategy = prior_init(model, model_args, model_kwargs,
                                       transforms)
    else:
        if potential_fn is None:
            raise ValueError("need a model or a potential_fn")
        if init_params is None:
            raise ValueError("potential_fn mode requires init_params")
        z_fixed, unravel = ravel({k: torch.as_tensor(v).to(device)
                                  for k, v in init_params.items()})
        potential_flat, constrain, prototype = potential_fn, unravel, z_fixed
    return (potential_flat, unravel, constrain, prototype, z_fixed,
            init_strategy)


def counting(potential_fn):
    """``potential_fn`` counting its calls in ``.count``: the samplers only
    evaluate the potential with its gradient, so the count is the number
    of gradient evaluations (one per chain and evaluation).  A potential
    with a batched entry (``value_and_grad_batch``, the fused GLM
    potential's) keeps it, counting C for a (C, D) call."""
    def potential(z):
        potential.count += 1
        return potential_fn(z)

    potential.count = 0
    batch = getattr(potential_fn, "value_and_grad_batch", None)
    if batch is not None:
        def value_and_grad_batch(z):
            potential.count += z.shape[0]
            return batch(z)

        potential.value_and_grad_batch = value_and_grad_batch
    return potential


def hmc_setup(generator, num_warmup, *, model=None, potential_fn=None,
              init_params=None, model_args=(), model_kwargs=None,
              algo="HMC", step_size=1.0, trajectory_length=2 * math.pi,
              adapt_step_size=True, adapt_mass_matrix=True, dense_mass=False,
              target_accept_prob=0.8, max_tree_depth=10,
              init_strategy="uniform", device="cuda") -> KernelSetup:
    """Build the :class:`KernelSetup` for HMC (``algo="HMC"``) or NUTS
    (``algo="NUTS"``).  ``generator`` seeds the structure-discovery trace
    only; per-chain randomness comes from the draw source given to
    ``init_fn``/``sample_fn``.  The chain runs on ``device`` (default
    ``"cuda"``; raises without CUDA unless ``device="cpu"``), where the
    model arguments must already lie."""
    if dense_mass:
        raise pending("dense_mass=True", "dense mass matrix")
    reads = HostReads()
    (potential_flat, unravel, constrain, prototype, z_fixed,
     init_strategy) = flat_model_ingredients(
        generator, device, model=model, potential_fn=potential_fn,
        init_params=init_params, model_args=model_args,
        model_kwargs=model_kwargs, init_strategy=init_strategy)
    schedule = build_adaptation_schedule(num_warmup)
    counted = counting(potential_flat)
    init_fn = _make_init_fn(
        counted, prototype, reads, z_fixed=z_fixed,
        adapt_step_size=adapt_step_size, step_size0=step_size,
        init_strategy=init_strategy)
    sample_fn = _make_sample_fn(
        counted, num_warmup, schedule, reads, algo=algo,
        trajectory_length=trajectory_length, adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix,
        target_accept_prob=target_accept_prob, max_tree_depth=max_tree_depth)
    return KernelSetup(
        init_fn=init_fn, sample_fn=sample_fn, collect_fn=_collect_fn,
        potential_fn=potential_flat, unravel_fn=unravel,
        constrain_fn=constrain, num_warmup=int(num_warmup), algo=algo,
        adapt_schedule=tuple((int(s), int(e)) for (s, e) in schedule),
        host_reads=reads, grad_evals=counted)


def nuts_setup(generator, num_warmup, **kwargs) -> KernelSetup:
    """:func:`hmc_setup` with the iterative No-U-Turn transition."""
    kwargs.pop("algo", None)
    kwargs.pop("trajectory_length", None)
    return hmc_setup(generator, num_warmup, algo="NUTS", **kwargs)


class HMC:
    """Vanilla HMC with a fixed trajectory length.

    ``device`` (default ``"cuda"``) is where the chain runs; without CUDA
    the constructor raises unless ``device="cpu"`` is given.
    """

    def __init__(self, model=None, potential_fn=None, step_size=1.0,
                 trajectory_length=2 * math.pi, adapt_step_size=True,
                 adapt_mass_matrix=True, dense_mass=False,
                 target_accept_prob=0.8, init_strategy="uniform",
                 device="cuda"):
        self.model = model
        self.potential_fn = potential_fn
        self.device = resolve_device(device)
        self._kwargs = dict(
            step_size=step_size, trajectory_length=trajectory_length,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix, dense_mass=dense_mass,
            target_accept_prob=target_accept_prob,
            init_strategy=init_strategy)
        self._algo = "HMC"

    def setup(self, generator, num_warmup, init_params=None, model_args=(),
              model_kwargs=None) -> KernelSetup:
        """Build the setup for this kernel's configuration."""
        return hmc_setup(
            generator, num_warmup, model=self.model,
            potential_fn=self.potential_fn if self.model is None else None,
            init_params=init_params, model_args=model_args,
            model_kwargs=model_kwargs, algo=self._algo, device=self.device,
            **self._kwargs)


class NUTS(HMC):
    """No-U-Turn Sampler with the paper's iterative tree."""

    def __init__(self, model=None, potential_fn=None, step_size=1.0,
                 adapt_step_size=True, adapt_mass_matrix=True,
                 dense_mass=False, target_accept_prob=0.8,
                 max_tree_depth=10, init_strategy="uniform", device="cuda"):
        super().__init__(model=model, potential_fn=potential_fn,
                         step_size=step_size, adapt_step_size=adapt_step_size,
                         adapt_mass_matrix=adapt_mass_matrix,
                         dense_mass=dense_mass,
                         target_accept_prob=target_accept_prob,
                         init_strategy=init_strategy, device=device)
        self._algo = "NUTS"
        self._kwargs["max_tree_depth"] = max_tree_depth
