"""HMC and NUTS as sampler kernels, with a diagonal or dense mass matrix.

:func:`hmc_setup` does the one-time work (tracing the model, building the
flat potential and the Stan-style windowed adaptation schedule) and returns
a :class:`~repro_torch.core.infer.kernel_api.KernelSetup` whose ``init_fn``
and ``sample_fn`` advance one chain.  The vectors of the chain state live on
the kernel's device; the scalars that steer it (energies, accept
probabilities, dual averaging) live on the host, so the step size is a
device scalar rewritten from the host value once per warmup transition.

The setup's ``init_batch_fn`` and ``sample_batch_fn`` move C chains in
lockstep (the JAX package's ``vmap`` over chains): the state's tensors lead
with the chain axis, its host scalars become (C,) numpy arrays, and each
chain draws from its own source exactly what it would draw alone
(``hmc_util.build_tree_batch``), so on the CPU chain c of a batch is chain c
of a sequential run bit for bit.  ``cross_chain_adapt=True`` makes the setup
cross-chain: the transition is the batched one, and at each middle-window
end the chains' Welford accumulators are pooled into one mass matrix that
every chain takes.

:func:`flat_model_ingredients` is the model-tracing preamble every
gradient-based setup shares (this one, ChEES's and MALA/RWM's).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...distributed import sharding
from ...distributed.sharding import DATA_AXIS
from ..errors import (NO_DEVICE, NO_SHARD_STRUCTURE, ReproRuntimeError,
                      ReproValueError)
from .hmc_util import (
    DAState,
    GeneratorDraws,
    HostReads,
    IntegratorState,
    WelfordState,
    build_adaptation_schedule,
    build_tree,
    build_tree_batch,
    dual_averaging_init,
    dual_averaging_update,
    find_reasonable_step_size,
    halfstep_chains,
    host_mask,
    is_dense,
    kinetic_energy,
    momentum_sample,
    rows_value_and_grad,
    to_device,
    value_and_grad,
    velocity_verlet,
    welford_covariance,
    welford_init,
    welford_pool,
    welford_update,
    window_predicates,
)
from .kernel_api import KernelSetup
from .util import (find_valid_initial_params, initialize_model_structure,
                   prior_init, ravel)

_F32 = np.float32


class AdaptState(NamedTuple):
    step_size: torch.Tensor            # device scalar, the chain's dtype
    inverse_mass_matrix: torch.Tensor  # (D,) diagonal or (D, D) dense
    da_state: DAState
    welford: WelfordState
    window_idx: int


class HMCState(NamedTuple):
    """One chain's state; a batch of C chains (``sample_batch_fn``) has
    the same fields with a leading chain axis: (C, ...) tensors and (C,)
    numpy arrays for the host scalars (the dual averaging's and the Welford
    count's too)."""

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


_HOST_DTYPES = {"i": np.int64, "energy": np.float32, "num_steps": np.int64,
                "accept_prob": np.float32, "mean_accept_prob": np.float32,
                "diverging": bool}


def stack_states(states) -> HMCState:
    """C one-chain states as one batched state (leaves lead with the chain
    axis)."""
    def host(values, dtype):
        return np.array(list(values), dtype)

    adapts = [s.adapt_state for s in states]
    das = [a.da_state for a in adapts]
    wfs = [a.welford for a in adapts]
    da = DAState(*(host((getattr(d, f) for d in das), dtype) for f, dtype in
                   (("x", np.float32), ("x_avg", np.float32),
                    ("g_avg", np.float32), ("t", np.int64),
                    ("prox_center", np.float32))))
    adapt = AdaptState(
        torch.stack([a.step_size for a in adapts]),
        torch.stack([a.inverse_mass_matrix for a in adapts]), da,
        WelfordState(torch.stack([w.mean for w in wfs]),
                     torch.stack([w.m2 for w in wfs]),
                     host((w.n for w in wfs), np.int64)),
        host((a.window_idx for a in adapts), np.int64))
    fields = {f: (torch.stack([getattr(s, f) for s in states])
                  if f not in _HOST_DTYPES
                  else host((getattr(s, f) for s in states), _HOST_DTYPES[f]))
              for f in HMCState._fields if f != "adapt_state"}
    return HMCState(adapt_state=adapt, **fields)


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
                  step_size0, init_strategy, dense_mass):
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
        imm = torch.eye(dim, dtype=z.dtype, device=z.device) if dense_mass \
            else torch.ones(dim, dtype=z.dtype, device=z.device)
        if adapt_step_size:
            step_size = find_reasonable_step_size(
                potential_fn, imm, z, pe, grad, draws, reads,
                init_step_size=step_size0)
        else:
            step_size = _F32(step_size0)
        adapt = AdaptState(_full(step_size, z), imm,
                           dual_averaging_init(np.log(step_size)),
                           welford_init(dim, z.dtype, z.device,
                                        diagonal=not dense_mass), 0)
        energy = _F32(reads.read(pe.reshape(1))[0])
        return HMCState(i=0, z=z, potential_energy=pe, z_grad=grad,
                        energy=energy, num_steps=0, accept_prob=_F32(0),
                        mean_accept_prob=_F32(0), diverging=False,
                        adapt_state=adapt)

    return init_fn


def _welford_reset(wf: WelfordState) -> WelfordState:
    return WelfordState(torch.zeros_like(wf.mean), torch.zeros_like(wf.m2),
                        np.zeros_like(wf.n) if isinstance(wf.n, np.ndarray)
                        else 0)


def _da_row(da: DAState, c: int) -> DAState:
    return DAState(da.x[c], da.x_avg[c], da.g_avg[c], int(da.t[c]),
                   da.prox_center[c])


def _host_rows(values, dtype):
    return np.array(list(values), dtype)


class LockstepCount:
    """The lockstep leapfrogs of a batched sampler (a leaf or leapfrog that
    moves every chain still running counts once)."""

    def __init__(self):
        self.leapfrogs = 0


def _make_sample_fn(potential_fn, num_warmup, schedule, reads, *, algo,
                    trajectory_length, adapt_step_size, adapt_mass_matrix,
                    target_accept_prob, max_tree_depth, pooled_mass=False):
    """The transitions ``(HMCState, draws) -> HMCState`` of one chain and
    ``(batched HMCState, [draws per chain]) -> batched HMCState`` of C
    chains in lockstep.

    ``pooled_mass=True`` defers the mass-matrix refresh: the per-chain
    Welford accumulators still collect draws in middle windows and dual
    averaging still restarts at window ends, but the inverse mass matrix is
    left as it is (and the accumulators are not reset), so the cross-chain
    wrapper can pool them at the window end."""
    in_middle_window, window_end_is_middle = window_predicates(schedule)
    pe_and_grad, vv_update = velocity_verlet(potential_fn)
    rows_pe_and_grad = rows_value_and_grad(potential_fn)

    def mass_update(imm, wf, z, t):
        """Welford accumulation and the window-end refresh; ``z`` and the
        accumulator may lead with a chain axis (their rows share ``n``)."""
        at_end = False
        if adapt_mass_matrix:
            if in_middle_window(t):
                wf = welford_update(wf, z)
            at_end = window_end_is_middle(t)
            if at_end and not pooled_mass:
                imm = welford_covariance(wf)
                wf = _welford_reset(wf)
        return imm, wf, at_end

    def step_size_update(da, accept_prob, at_end, t):
        """One chain's dual averaging on log step size (host float32): the
        update, the restart from the average at a middle-window end, the
        freeze at the last warmup step.  Returns ``(da, step_size or
        None)``."""
        if not adapt_step_size:
            return da, None
        da = dual_averaging_update(da, _F32(target_accept_prob) - accept_prob)
        step_size = np.exp(da.x)
        if at_end:
            step_size = np.exp(da.x_avg)
            da = dual_averaging_init(np.log(step_size))
        if t == num_warmup - 1:
            step_size = np.exp(da.x_avg)
        return da, step_size

    def adapt_update(state: HMCState, accept_prob) -> AdaptState:
        adapt = state.adapt_state
        imm, wf, at_end = mass_update(adapt.inverse_mass_matrix,
                                      adapt.welford, state.z, state.i)
        da, step_size = step_size_update(adapt.da_state, accept_prob, at_end,
                                         state.i)
        step_tensor = adapt.step_size if step_size is None \
            else _full(step_size, adapt.step_size)
        return AdaptState(step_tensor, imm, da, wf,
                          adapt.window_idx + int(at_end))

    def adapt_update_batch(state: HMCState, accept_prob) -> AdaptState:
        adapt = state.adapt_state
        t, chains = int(state.i[0]), state.z.shape[0]
        wf = adapt.welford._replace(n=int(adapt.welford.n[0]))
        imm, wf, at_end = mass_update(adapt.inverse_mass_matrix, wf, state.z,
                                      t)
        wf = wf._replace(n=np.full(chains, wf.n, np.int64))
        rows = [step_size_update(_da_row(adapt.da_state, c), accept_prob[c],
                                 at_end, t) for c in range(chains)]
        da = DAState(*(_host_rows(v, dtype) for v, dtype in zip(
            zip(*(d for d, _ in rows)),
            (np.float32, np.float32, np.float32, np.int64, np.float32))))
        step_tensor = adapt.step_size
        if adapt_step_size:
            step_tensor = to_device(torch.tensor(
                [float(size) for _, size in rows],
                dtype=adapt.step_size.dtype), adapt.step_size.device)
        return AdaptState(step_tensor, imm, da, wf,
                          adapt.window_idx + int(at_end))

    def trajectory_steps(step_size):
        return int(min(max(math.ceil(_F32(trajectory_length)
                                     / _F32(step_size)), 1), 1024))

    def metropolis(energy_new, energy_cur, u):
        """``(accept_prob, accepted, diverging)`` of one HMC proposal."""
        delta = _F32(np.inf) if np.isnan(energy_new) \
            else _F32(energy_new - energy_cur)
        accept_prob = _F32(1) if delta <= 0 else _F32(np.exp(-delta))
        return accept_prob, bool(u() < accept_prob), bool(delta > 1000.0)

    def running_mean(in_warmup, i, mean, accept_prob):
        if in_warmup:
            return accept_prob
        n_post = max(i - num_warmup, 1)
        return _F32(mean + (accept_prob - mean) / n_post)

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
            num_steps = trajectory_steps(vals[2])
            nxt = start
            for _ in range(num_steps):
                nxt = vv_update(step_size, imm, nxt)
            new = reads.read(torch.stack([nxt.potential_energy,
                                          kinetic_energy(imm, nxt.r)]))
            energy_new = _F32(new[0]) + _F32(new[1])
            accept_prob, accepted, diverging = metropolis(
                energy_new, energy_cur, draws.accept_uniform)
            if accepted:
                z, pe, grad, energy = (nxt.z, nxt.potential_energy,
                                       nxt.z_grad, energy_new)
            else:
                pe, grad, energy = (state.potential_energy, state.z_grad,
                                    energy_cur)
        in_warmup = state.i < num_warmup
        new_adapt = adapt_update(state, accept_prob) if in_warmup else adapt
        i = state.i + 1
        # running mean accept prob over the post-warmup phase
        mean_ap = running_mean(in_warmup, i, state.mean_accept_prob,
                               accept_prob)
        return HMCState(i, z, pe, grad, energy, num_steps, accept_prob,
                        mean_ap, diverging, new_adapt)

    def hmc_trajectories(start, imm, step_size, steps):
        """Each chain's ``steps[c]`` leapfrogs in lockstep; a chain that has
        finished is frozen bit for bit while the others go on."""
        z, r, pe, grad = start
        for k in range(int(steps.max())):
            live = steps > k
            live_dev = host_mask(live, z.device)
            z, r = halfstep_chains(z, r, grad, imm, step_size, live_dev)
            pe_new, grad_new = rows_pe_and_grad(z, live)
            keep = live_dev.reshape(-1, 1)
            pe = torch.where(live_dev, pe_new, pe)
            grad = torch.where(keep, grad_new, grad)
            r = torch.where(keep, r - (0.5 * step_size).reshape(-1, 1) * grad,
                            r)
        sample_batch.lockstep.leapfrogs += int(steps.max())
        return IntegratorState(z, r, pe, grad)

    def sample_batch(state: HMCState, draws) -> HMCState:
        adapt = state.adapt_state
        imm, step_size = adapt.inverse_mass_matrix, adapt.step_size
        z = state.z
        chains, dim = z.shape
        noise = to_device(torch.stack([d.momentum(dim, z.dtype)
                                       for d in draws]), z.device)
        dense = is_dense(imm, noise)
        r = torch.stack([momentum_sample(noise[c], imm[c])
                         for c in range(chains)]) if dense \
            else momentum_sample(noise, imm)
        ke = torch.stack([kinetic_energy(imm[c], r[c])
                          for c in range(chains)])
        vals = reads.read(torch.stack([state.potential_energy, ke,
                                       step_size]))
        energy_cur = _host_rows((_F32(vals[0][c]) + _F32(vals[1][c])
                                 for c in range(chains)), np.float32)
        start = IntegratorState(z, r, state.potential_energy, state.z_grad)
        if algo == "NUTS":
            tree, leaves = build_tree_batch(
                rows_pe_and_grad, imm, step_size, draws, start, energy_cur,
                reads, max_tree_depth=max_tree_depth)
            sample_batch.lockstep.leapfrogs += leaves
            accept_prob = _host_rows(
                (_F32(tree.sum_accept_probs[c]
                      / max(int(tree.num_proposals[c]), 1))
                 for c in range(chains)), np.float32)
            z, pe, grad = (tree.z_proposal, tree.z_proposal_pe,
                           tree.z_proposal_grad)
            energy = tree.z_proposal_energy
            num_steps = tree.num_proposals
            diverging = tree.diverging
        else:
            num_steps = _host_rows((trajectory_steps(v) for v in vals[2]),
                                   np.int64)
            nxt = hmc_trajectories(start, imm, step_size, num_steps)
            ke_new = torch.stack([kinetic_energy(imm[c], nxt.r[c])
                                  for c in range(chains)])
            new = reads.read(torch.stack([nxt.potential_energy, ke_new]))
            energy_new = [_F32(new[0][c]) + _F32(new[1][c])
                          for c in range(chains)]
            tests = [metropolis(energy_new[c], energy_cur[c],
                                draws[c].accept_uniform)
                     for c in range(chains)]
            accept_prob = _host_rows((t[0] for t in tests), np.float32)
            accepted = _host_rows((t[1] for t in tests), bool)
            diverging = _host_rows((t[2] for t in tests), bool)
            acc = host_mask(accepted, z.device)
            z = torch.where(acc.reshape(-1, 1), nxt.z, z)
            pe = torch.where(acc, nxt.potential_energy,
                             state.potential_energy)
            grad = torch.where(acc.reshape(-1, 1), nxt.z_grad, state.z_grad)
            energy = np.where(accepted, np.array(energy_new, np.float32),
                              energy_cur)
        t = int(state.i[0])
        in_warmup = t < num_warmup
        new_adapt = adapt_update_batch(state, accept_prob) if in_warmup \
            else adapt
        i = state.i + 1
        mean_ap = _host_rows((running_mean(in_warmup, t + 1,
                                           state.mean_accept_prob[c],
                                           accept_prob[c])
                              for c in range(chains)), np.float32)
        return HMCState(i, z, pe, grad, energy, num_steps, accept_prob,
                        mean_ap, diverging, new_adapt)

    sample_batch.lockstep = LockstepCount()
    return sample_fn, sample_batch


def _cross_chain_wrap(init_batch, sample_batch, schedule, num_warmup, *,
                      pool_mass):
    """Lift the lockstep transition to the cross-chain contract with pooled
    mass adaptation: after the batched transition (whose ``pooled_mass``
    adaptation accumulates but never refreshes), at a middle-window end
    (every chain shares the iteration counter) the chains' Welford
    accumulators are pooled, the shared covariance goes into every chain's
    inverse mass matrix and the accumulators restart.  ``init_fn`` takes
    the chains' draw sources (and ignores a shared one), ``sample_fn`` the
    batched state and the chains' draw sources.  Under a mesh that splits
    the batch over chain ranks (``chain_method="parallel"``), the chains'
    accumulators are gathered over the chains dim first, so every rank
    pools all C chains in the same order."""
    _, window_end_is_middle = window_predicates(schedule)

    def init_fn(chain_draws, draws=None):
        return init_batch(chain_draws)

    def sample_fn(state: HMCState, chain_draws) -> HMCState:
        state = sample_batch(state, chain_draws)
        t = int(state.i[0]) - 1  # the iteration just completed
        if not (pool_mass and t < num_warmup and window_end_is_middle(t)):
            return state
        adapt = state.adapt_state
        welford, group = adapt.welford, sharding.active_chain_rows()
        if group is not None:
            welford = sharding.gather_tree(welford, group)
        imm = welford_covariance(welford_pool(welford))
        chains = state.z.shape[0]
        imm = imm.expand((chains,) + tuple(imm.shape)).contiguous()
        return state._replace(adapt_state=adapt._replace(
            inverse_mass_matrix=imm, welford=_welford_reset(adapt.welford)))

    sample_fn.lockstep = sample_batch.lockstep
    return init_fn, sample_fn


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


def _metrics_fn(state: HMCState):
    """The metrics stream (``KernelSetup.metrics_fn``): scalars for one
    chain's state and (C,) leaves for the lockstep batched state, in a few
    tensor ops (no loop over the chains); the host scalars are the state's
    own.  ``num_steps`` is the trajectory's leapfrog count (the tree-depth
    signal for NUTS); ``mass_trace`` is the trace of a dense inverse mass or
    the sum of a diagonal one.  It reads the state only."""
    imm = state.adapt_state.inverse_mass_matrix
    mass_trace = imm.diagonal(dim1=-2, dim2=-1).sum(-1) \
        if imm.ndim > state.z.ndim else imm.sum(-1)
    return {
        "step_size": state.adapt_state.step_size,
        "accept_prob": state.accept_prob,
        "diverging": state.diverging,
        "num_steps": state.num_steps,
        "energy": state.energy,
        "mass_trace": mass_trace,
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
    :func:`prior_init` proposal).  ``data_shards=S`` asks for the fused GLM
    potential's S-shard fold (:mod:`repro_torch.core.infer.glm`), honoured
    in model mode for a likelihood that fuses; :func:`resolve_data_axis`
    raises ``RPL302`` when it is not."""
    device = resolve_device(device)
    model_kwargs = model_kwargs or {}
    if model is not None:
        _check_on_device((model_args, model_kwargs), device)
        (potential_flat, unravel, transforms, constrain, _,
         prototype) = initialize_model_structure(generator, model,
                                                 model_args, model_kwargs,
                                                 data_shards=data_shards)
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


def resolve_data_axis(potential_flat, data_shards):
    """``KernelSetup.data_axis`` for a potential built with
    ``data_shards``: None without shards, else ``"data"``, when the
    potential carries the shard-aware fold's marker (``data_shards``, set
    by ``glm.maybe_fuse_glm_potential``).  A raw ``potential_fn``, or a
    model whose likelihood fell back to the plain path, has no per-shard
    structure, and a data mesh under it would evaluate every row on every
    rank: ``ReproValueError`` ``RPL302`` instead, and for a marker of
    another shard count."""
    if data_shards is None:
        return None
    marker = getattr(potential_flat, "data_shards", None)
    if marker is None:
        raise ReproValueError(
            f"data_shards={data_shards} was requested but no shard-aware "
            "potential was built: the model's likelihood did not fuse "
            "(watch for the fallback warning), or a raw potential_fn was "
            "passed.  Data-sharded inference needs the fused GLM potential "
            "(mark the observed site with infer={'potential': 'glm'}).",
            code=NO_SHARD_STRUCTURE)
    if int(marker) != int(data_shards):
        raise ReproValueError(
            f"potential carries data_shards={marker} but the kernel was "
            f"asked for data_shards={data_shards}.", code=NO_SHARD_STRUCTURE)
    return DATA_AXIS


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
    if hasattr(potential_fn, "data_shards"):
        potential.data_shards = potential_fn.data_shards
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
              init_strategy="uniform", cross_chain_adapt=False,
              data_shards=None, device="cuda") -> KernelSetup:
    """Build the :class:`KernelSetup` for HMC (``algo="HMC"``) or NUTS
    (``algo="NUTS"``).  ``generator`` seeds the structure-discovery trace
    only; per-chain randomness comes from the draw source given to
    ``init_fn``/``sample_fn``.  The chain runs on ``device`` (default
    ``"cuda"``; raises without CUDA unless ``device="cpu"``), where the
    model arguments must already lie.

    ``dense_mass=True`` adapts a dense (D, D) inverse mass matrix; its
    leapfrogs are plain torch with ``m_inv @ r`` (the JAX package fuses only
    the diagonal path), so it launches no NUTS leaf kernel.
    ``cross_chain_adapt=True`` returns a cross-chain setup
    (``KernelSetup.cross_chain``): ``init_fn(chain_draws)`` and
    ``sample_fn(state, chain_draws)`` move the batch in lockstep, and at
    every middle-window end the chains' Welford accumulators are pooled
    (``welford_pool``) into one inverse mass matrix that every chain takes;
    dual averaging stays per chain.  ``data_shards=S`` gives the fused
    GLM likelihood an S-shard fold (``KernelSetup.data_axis`` ``"data"``:
    under ``chain_method="parallel"`` a mesh's data ranks evaluate their
    shards); ``RPL302`` without a shard-aware potential."""
    reads = HostReads()
    (potential_flat, unravel, constrain, prototype, z_fixed,
     init_strategy) = flat_model_ingredients(
        generator, device, model=model, potential_fn=potential_fn,
        init_params=init_params, model_args=model_args,
        model_kwargs=model_kwargs, data_shards=data_shards,
        init_strategy=init_strategy)
    data_axis = resolve_data_axis(potential_flat, data_shards)
    schedule = build_adaptation_schedule(num_warmup)
    counted = counting(potential_flat)
    init_fn = _make_init_fn(
        counted, prototype, reads, z_fixed=z_fixed,
        adapt_step_size=adapt_step_size, step_size0=step_size,
        init_strategy=init_strategy, dense_mass=dense_mass)
    sample_fn, sample_batch = _make_sample_fn(
        counted, num_warmup, schedule, reads, algo=algo,
        trajectory_length=trajectory_length, adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix,
        target_accept_prob=target_accept_prob, max_tree_depth=max_tree_depth,
        pooled_mass=cross_chain_adapt and adapt_mass_matrix)

    chain_init = init_fn

    def init_batch(chain_draws):
        return stack_states([chain_init(d) for d in chain_draws])

    if cross_chain_adapt:
        init_fn, sample_fn = _cross_chain_wrap(
            init_batch, sample_batch, schedule, num_warmup,
            pool_mass=adapt_mass_matrix)
        init_batch, sample_batch = init_fn, sample_fn
    return KernelSetup(
        init_fn=init_fn, sample_fn=sample_fn, collect_fn=_collect_fn,
        potential_fn=potential_flat, unravel_fn=unravel,
        constrain_fn=constrain, num_warmup=int(num_warmup), algo=algo,
        adapt_schedule=tuple((int(s), int(e)) for (s, e) in schedule),
        host_reads=reads, grad_evals=counted, cross_chain=cross_chain_adapt,
        init_batch_fn=init_batch, sample_batch_fn=sample_batch,
        metrics_fn=_metrics_fn, data_axis=data_axis)


def nuts_setup(generator, num_warmup, **kwargs) -> KernelSetup:
    """:func:`hmc_setup` with the iterative No-U-Turn transition."""
    kwargs.pop("algo", None)
    kwargs.pop("trajectory_length", None)
    return hmc_setup(generator, num_warmup, algo="NUTS", **kwargs)


def _init_draws(setup, generator, draws):
    """The draw source(s) an entry point's ``init_fn`` takes: ``draws`` as
    given, else one drawn from ``generator`` (a list of one for a
    cross-chain setup)."""
    if draws is None:
        draws = GeneratorDraws(generator)
    if setup.cross_chain and not isinstance(draws, (list, tuple)):
        draws = [draws]
    return draws


def hmc_init(generator, num_warmup, draws=None, **kwargs):
    """Functional entry point: ``-> (HMCState, KernelSetup)``.  The state
    draws from ``draws`` (a source, or a list of them for a cross-chain
    setup), by default from ``generator`` after the setup's trace."""
    setup = hmc_setup(generator, num_warmup, **kwargs)
    return setup.init_fn(_init_draws(setup, generator, draws)), setup


def nuts_init(generator, num_warmup, draws=None, **kwargs):
    """Functional entry point: ``-> (HMCState, KernelSetup)``, as
    :func:`hmc_init` with the No-U-Turn transition."""
    setup = nuts_setup(generator, num_warmup, **kwargs)
    return setup.init_fn(_init_draws(setup, generator, draws)), setup


class HMC:
    """Vanilla HMC with a fixed trajectory length.

    ``device`` (default ``"cuda"``) is where the chain runs; without CUDA
    the constructor raises unless ``device="cpu"`` is given.  ``setup``
    builds the functional core; ``init`` builds it and returns the initial
    state.
    """

    def __init__(self, model=None, potential_fn=None, step_size=1.0,
                 trajectory_length=2 * math.pi, adapt_step_size=True,
                 adapt_mass_matrix=True, dense_mass=False,
                 target_accept_prob=0.8, init_strategy="uniform",
                 cross_chain_adapt=False, data_shards=None, device="cuda"):
        self.model = model
        self.potential_fn = potential_fn
        self.device = resolve_device(device)
        self.cross_chain = cross_chain_adapt
        self._kwargs = dict(
            step_size=step_size, trajectory_length=trajectory_length,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix, dense_mass=dense_mass,
            target_accept_prob=target_accept_prob,
            init_strategy=init_strategy, cross_chain_adapt=cross_chain_adapt,
            data_shards=data_shards)
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

    def init(self, generator, num_warmup, init_params=None, model_args=(),
             model_kwargs=None, draws=None):
        """Build the setup and return the initial state, drawing from
        ``draws`` (by default from ``generator`` after the setup's trace)."""
        setup = self.setup(generator, num_warmup, init_params=init_params,
                           model_args=model_args, model_kwargs=model_kwargs)
        return setup.init_fn(_init_draws(setup, generator, draws))


class NUTS(HMC):
    """No-U-Turn Sampler with the paper's iterative tree."""

    def __init__(self, model=None, potential_fn=None, step_size=1.0,
                 adapt_step_size=True, adapt_mass_matrix=True,
                 dense_mass=False, target_accept_prob=0.8,
                 max_tree_depth=10, init_strategy="uniform",
                 cross_chain_adapt=False, data_shards=None, device="cuda"):
        super().__init__(model=model, potential_fn=potential_fn,
                         step_size=step_size, adapt_step_size=adapt_step_size,
                         adapt_mass_matrix=adapt_mass_matrix,
                         dense_mass=dense_mass,
                         target_accept_prob=target_accept_prob,
                         init_strategy=init_strategy,
                         cross_chain_adapt=cross_chain_adapt,
                         data_shards=data_shards, device=device)
        self._algo = "NUTS"
        self._kwargs["max_tree_depth"] = max_tree_depth
