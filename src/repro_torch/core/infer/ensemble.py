"""Cross-chain ensemble inference: ChEES-HMC with lockstep trajectories.

The port of the JAX package's ``core/infer/ensemble.py`` (Hoffman, Radul &
Sountsov, 2021):

- **Lockstep trajectories.** Every chain runs the same number of leapfrog
  steps per iteration, one ``(C, D)`` ensemble through
  :class:`~repro_torch.core.infer.graphs.EnsembleTrajectory`: the momentum
  draw and opening half-kick in one ``chees_open`` launch (row 3's kernel),
  the interior steps through ``leapfrog_halfstep_batch`` with merged kicks,
  each followed by the potential of all chains.  On a card, with a
  potential that can be replayed, the opening and the interior leapfrog
  each replay from a CUDA graph (``MCMC.stats["trajectory_graph"]``).
- **Halton jitter.** The shared trajectory length is scaled each iteration
  by a van der Corput factor in (0, 1).
- **ChEES criterion.** Adam ascends the Rao-Blackwellized estimate of the
  criterion's gradient in the log trajectory length, divergent chains
  weighted 0.
- **Cross-chain step size.** One dual-averaging run on the chains'
  harmonic-mean acceptance probability (target 0.651).
- **Pooled mass matrix.** One Welford estimator folds in the whole ensemble
  every middle-window iteration; at a window end it refreshes the shared
  diagonal mass, restarts dual averaging and resets Adam.

The ensemble's vectors (positions, momenta, gradients, energies, accept
probabilities) stay on the device.  Its shared scalars live on the host in
float32, with the JAX package's float32 arithmetic: the step size, the log
trajectory length, Adam and dual averaging, and ``num_steps`` from
:func:`halton`.  After the trajectory one ``ops.chees_accept`` launch closes
the transition: the closing half-kick, both energies, the Metropolis test,
the selection, the running mean after warmup, and in warmup the
harmonic-mean accept probability and the ChEES gradient packed for the
host's one read of the iteration, and, in a middle window, the pooled
Welford fold.  A sampling iteration reads nothing.
``MCMC.stats["host_syncs"]`` counts the reads.

Randomness: one shared draw source moves the whole ensemble (its ``(C, D)``
momenta and ``(C,)`` accept uniforms, drawn in that order), as the
reference splits one shared key; on a card both go to the device with the
step size in one copy.  Each chain keeps its own source for its
initial-point search.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...kernels import ops
from .graphs import EnsembleTrajectory
from .hmc import counting, flat_model_ingredients, resolve_device
from .hmc_util import (
    DAState,
    HostReads,
    WelfordState,
    build_adaptation_schedule,
    dual_averaging_init,
    dual_averaging_update,
    find_reasonable_step_size,
    split_draws,
    value_and_grad,
    welford_covariance,
    welford_init,
    welford_ratios,
    window_predicates,
)
from .kernel_api import KernelSetup
from .util import find_valid_initial_params

_F32 = np.float32

# optimal acceptance rate for jittered HMC (Hoffman et al. 2021)
DEFAULT_TARGET_ACCEPT = 0.651


class AdamState(NamedTuple):
    m: np.float32
    v: np.float32
    t: int


def adam_init():
    return AdamState(_F32(0), _F32(0), 0)


def adam_step(state: AdamState, grad, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam *ascent* step on a host float32 scalar; returns ``(delta,
    new_state)``.  Constants enter as the JAX package's weakly typed Python
    floats do: computed in Python, then rounded to float32."""
    t = state.t + 1
    grad = _F32(grad)
    m = _F32(b1) * state.m + _F32(1 - b1) * grad
    v = _F32(b2) * state.v + _F32(1 - b2) * grad * grad
    tf = _F32(t)
    m_hat = m / (_F32(1) - _F32(b1) ** tf)
    v_hat = v / (_F32(1) - _F32(b2) ** tf)
    delta = _F32(lr) * m_hat / (np.sqrt(v_hat) + _F32(eps))
    return _F32(delta), AdamState(_F32(m), _F32(v), t)


def halton(t, bits=16):
    """Base-2 van der Corput radical inverse of ``t + 1`` (period
    ``2**bits``), as a float32."""
    t = (int(t) + 1) & 0xFFFFFFFF
    out = _F32(0)
    for b in range(bits):
        out = _F32(out + _F32((t >> b) & 1) * _F32(0.5 ** (b + 1)))
    return out


class ChEESAdaptState(NamedTuple):
    """Shared (cross-chain) adaptation state; scalars on the host."""
    step_size: np.float32             # shared by every chain
    inverse_mass_matrix: torch.Tensor  # (D,) diagonal, shared, on the device
    da_state: DAState                 # dual averaging on the mean accept
    log_traj: np.float32              # log trajectory length (pre-jitter)
    adam_state: AdamState             # Adam moments of the ChEES ascent
    welford: WelfordState             # pooled (D,) estimator over all chains


class ChEESState(NamedTuple):
    """The ensemble: per-chain tensors lead with the chain axis C; ``i``,
    ``num_steps`` and ``adapt_state`` are shared."""
    i: int
    z: torch.Tensor                   # (C, D) flat unconstrained positions
    potential_energy: torch.Tensor    # (C,)
    z_grad: torch.Tensor              # (C, D)
    energy: torch.Tensor              # (C,)
    num_steps: int                    # the same for every chain
    accept_prob: torch.Tensor         # (C,)
    mean_accept_prob: torch.Tensor    # (C,) running post-warmup mean
    diverging: torch.Tensor           # (C,) bool
    adapt_state: ChEESAdaptState


def initial_positions(potential_fn, prototype, chain_draws, reads, *, z_fixed,
                      init_strategy):
    """Each chain's initial point (its own draw source; ``z_fixed`` for
    all when given), with potential and gradient, stacked to ``(C, ...)``."""
    pe_and_grad = value_and_grad(potential_fn)

    def one_chain(draws):
        if z_fixed is not None:
            return (z_fixed,) + pe_and_grad(z_fixed)
        return find_valid_initial_params(draws, potential_fn, prototype,
                                         init_strategy=init_strategy,
                                         reads=reads)

    z, pe, grad = zip(*(one_chain(d) for d in chain_draws))
    return torch.stack(z), torch.stack(pe), torch.stack(grad)


def _make_init_fn(potential_fn, prototype, reads, *, z_fixed,
                  adapt_step_size, step_size0, init_strategy):
    """Batch init: per-chain position search, then the shared scalars: one
    reasonable-step-size search from chain 0 with the shared draws, unit
    mass, trajectory length 1.0 (the ChEES ascent owns it from there)."""
    dim = prototype.numel()

    def init_fn(chain_draws, draws):
        z, pe, grad = initial_positions(
            potential_fn, prototype, chain_draws, reads, z_fixed=z_fixed,
            init_strategy=init_strategy)
        num_chains = z.shape[0]
        imm = torch.ones(dim, dtype=z.dtype, device=z.device)
        if adapt_step_size:
            step_size = find_reasonable_step_size(
                potential_fn, imm, z[0], pe[0], grad[0], draws, reads,
                init_step_size=step_size0)
        else:
            step_size = _F32(step_size0)
        adapt = ChEESAdaptState(
            step_size=step_size, inverse_mass_matrix=imm,
            da_state=dual_averaging_init(np.log(step_size)),
            log_traj=_F32(0), adam_state=adam_init(),
            welford=welford_init(dim, z.dtype, z.device))
        zeros = z.new_zeros(num_chains)
        return ChEESState(
            i=0, z=z, potential_energy=pe, z_grad=grad, energy=pe,
            num_steps=0, accept_prob=zeros, mean_accept_prob=zeros,
            diverging=torch.zeros(num_chains, dtype=torch.bool,
                                  device=z.device),
            adapt_state=adapt)

    return init_fn


def refresh_mass(wf: WelfordState, da: DAState, step_size,
                 adapt_step_size):
    """A middle window's end: the pooled estimate becomes the shared
    inverse mass, the estimator restarts, and dual averaging restarts from
    its averaged iterate.  Returns ``(imm, welford, da, step_size)``."""
    imm = welford_covariance(wf)
    wf_reset = welford_init(imm.numel(), imm.dtype, imm.device)
    if adapt_step_size:
        step_size = _F32(np.exp(da.x_avg))
        da = dual_averaging_init(np.log(step_size))
    return imm, wf_reset, da, step_size


def _make_sample_fn(potential_fn, num_warmup, schedule, reads, *,
                    adapt_step_size, adapt_mass_matrix, adapt_trajectory,
                    target_accept_prob, learning_rate, max_num_steps,
                    graphed, max_delta_energy=1000.0):
    """The ensemble transition ``(ChEESState, draws) -> ChEESState``."""
    in_middle_window, window_end_is_middle = window_predicates(schedule)
    trajectory = EnsembleTrajectory(potential_fn, graphed)
    # static bounds on the learned length, wide enough to be inert
    log_traj_lo, log_traj_hi = np.log(_F32(1e-3)), np.log(_F32(1e3))

    def adapt_update(adapt: ChEESAdaptState, t, vals, folded,
                     num_chains) -> ChEESAdaptState:
        """The host's half of a warmup iteration, from its one read
        ``vals = [harmonic-mean accept prob, ChEES gradient]`` and the
        device's fold of the ``num_chains`` new draws into the pooled
        Welford accumulator (``folded``, or None outside a middle
        window)."""
        # 1) dual averaging on the harmonic-mean accept prob
        da, step_size = adapt.da_state, adapt.step_size
        if adapt_step_size:
            da = dual_averaging_update(
                da, _F32(target_accept_prob) - _F32(vals[0]))
            step_size = _F32(np.exp(da.x))
        # 2) the ChEES ascent on the log trajectory length
        log_traj, adam = adapt.log_traj, adapt.adam_state
        if adapt_trajectory:
            delta, adam = adam_step(adam, vals[1], learning_rate)
            log_traj = _F32(np.clip(_F32(log_traj + delta), log_traj_lo,
                                    log_traj_hi))
        imm, wf = adapt.inverse_mass_matrix, adapt.welford
        if adapt_mass_matrix:
            # 3) pooled Welford: the whole ensemble folded in at once
            if folded is not None:
                wf = WelfordState(*folded, wf.n + num_chains)
            # 4) a middle window's end: refresh the mass, restart Adam too
            #    (its moments belong to the old geometry)
            if window_end_is_middle(t):
                imm, wf, da, step_size = refresh_mass(wf, da, step_size,
                                                      adapt_step_size)
                adam = adam_init()
        # last warmup step: sample with the averaged dual-averaging iterate
        if adapt_step_size and t == num_warmup - 1:
            step_size = _F32(np.exp(da.x_avg))
        return ChEESAdaptState(step_size, imm, da, log_traj, adam, wf)

    def sample_fn(state: ChEESState, draws) -> ChEESState:
        num_chains, dim = state.z.shape
        adapt = state.adapt_state
        imm, step_size = adapt.inverse_mass_matrix, adapt.step_size
        # the shared jittered trajectory: one leapfrog count for all chains
        h = halton(state.i)
        steps = np.ceil(_F32(h * np.exp(adapt.log_traj)) / step_size)
        num_steps = int(np.clip(np.nan_to_num(steps, nan=1.0,
                                              posinf=max_num_steps),
                                1, max_num_steps))
        n = draws.momentum_batch(num_chains, dim, state.z.dtype)
        u = draws.accept_uniforms(num_chains, state.z.dtype)
        n, u, eps = trajectory.stage(n, u, step_size, state.z.device)
        z1, r, pe1, g1 = trajectory(state.z, state.z_grad, n, imm, eps,
                                    num_steps)
        t = state.i
        in_warmup = t < num_warmup
        fold = None
        if in_warmup and adapt_mass_matrix and in_middle_window(t):
            wf = adapt.welford
            fold = (wf.mean, wf.m2, *welford_ratios(wf.n, num_chains))
        (z, pe, grad, energy, accept_prob, diverging, mean_ap, stats,
         folded) = ops.chees_accept(
            state.z, state.potential_energy, state.z_grad, n, imm, z1, r,
            pe1, g1, eps, u, max_delta_energy, state.mean_accept_prob,
            0 if in_warmup else t + 1 - num_warmup,
            float(h) if in_warmup and adapt_trajectory else None, fold)
        new_adapt = adapt
        if in_warmup:
            # the one host read of a warmup iteration
            vals = reads.read(stats) \
                if adapt_step_size or adapt_trajectory else None
            new_adapt = adapt_update(adapt, t, vals, folded, num_chains)
        return ChEESState(t + 1, z, pe, grad, energy, num_steps, accept_prob,
                          mean_ap, diverging, new_adapt)

    sample_fn.trajectory_stats = trajectory.stats
    return sample_fn


def _collect_fn(state: ChEESState):
    """Per-draw outputs; the shared host scalars broadcast over the chain
    axis (as numpy rows) so every leaf leads with C."""
    num_chains = state.z.shape[0]
    adapt = state.adapt_state
    return {
        "z": state.z,
        "potential_energy": state.potential_energy,
        "energy": state.energy,
        "num_steps": np.full(num_chains, state.num_steps, np.int32),
        "accept_prob": state.accept_prob,
        "diverging": state.diverging,
        "step_size": np.full(num_chains, adapt.step_size, np.float32),
        "trajectory_length": np.full(num_chains, np.exp(adapt.log_traj),
                                     np.float32),
    }


def _metrics_fn(state: ChEESState):
    """The metrics stream under the cross-chain contract: what the ensemble
    adapts stays one value a draw (the shared step size, trajectory length
    and leapfrog count, host scalars, and the pooled inverse mass's sum),
    per-chain diagnostics are (C,).  It reads the state only: the per-chain
    tensors are ``chees_accept``'s fresh outputs, never the trajectory's
    graph buffers."""
    adapt = state.adapt_state
    return {
        "step_size": adapt.step_size,
        "trajectory_length": np.exp(adapt.log_traj),
        "num_steps": state.num_steps,
        "mass_trace": adapt.inverse_mass_matrix.sum(),
        "accept_prob": state.accept_prob,
        "diverging": state.diverging,
        "energy": state.energy,
    }


def chees_setup(generator, num_warmup, *, model=None, potential_fn=None,
                init_params=None, model_args=(), model_kwargs=None,
                step_size=1.0, adapt_step_size=True, adapt_mass_matrix=True,
                adapt_trajectory=True,
                target_accept_prob=DEFAULT_TARGET_ACCEPT,
                learning_rate=0.05, max_num_steps=256,
                init_strategy="uniform", data_shards=None,
                device="cuda") -> KernelSetup:
    """Build the cross-chain :class:`KernelSetup` for ChEES-HMC on
    ``device`` (default ``"cuda"``; raises without CUDA unless
    ``device="cpu"``).  ``data_shards`` waits for the multi-GPU slice."""
    reads = HostReads()
    (potential_flat, unravel, constrain, prototype, z_fixed,
     init_strategy) = flat_model_ingredients(
        generator, device, model=model, potential_fn=potential_fn,
        init_params=init_params, model_args=model_args,
        model_kwargs=model_kwargs, data_shards=data_shards,
        init_strategy=init_strategy)
    schedule = build_adaptation_schedule(num_warmup)
    counted = counting(potential_flat)
    init_fn = _make_init_fn(
        counted, prototype, reads, z_fixed=z_fixed,
        adapt_step_size=adapt_step_size, step_size0=step_size,
        init_strategy=init_strategy)
    # replay the trajectory from CUDA graphs where the potential can be
    # replayed: the batched prior under torch.func.vmap (graphs.py)
    graphed = prototype.device.type == "cuda" and getattr(
        potential_flat, "glm_prior_batch", None) == "vmap"
    sample_fn = _make_sample_fn(
        counted, num_warmup, schedule, reads,
        adapt_step_size=adapt_step_size, adapt_mass_matrix=adapt_mass_matrix,
        adapt_trajectory=adapt_trajectory,
        target_accept_prob=target_accept_prob, learning_rate=learning_rate,
        max_num_steps=max_num_steps, graphed=graphed)
    return KernelSetup(
        init_fn=init_fn, sample_fn=sample_fn, collect_fn=_collect_fn,
        potential_fn=potential_flat, unravel_fn=unravel,
        constrain_fn=constrain, num_warmup=int(num_warmup), algo="ChEES",
        adapt_schedule=tuple((int(s), int(e)) for (s, e) in schedule),
        host_reads=reads, grad_evals=counted, cross_chain=True,
        metrics_fn=_metrics_fn)


def chees_init(generator, num_warmup, chain_draws, draws, **kwargs):
    """Functional entry point: ``-> (ChEESState, KernelSetup)`` for the
    ensemble of ``len(chain_draws)`` chains."""
    setup = chees_setup(generator, num_warmup, **kwargs)
    return setup.init_fn(chain_draws, draws), setup


class ChEES:
    """ChEES-HMC ensemble kernel for :class:`~repro_torch.core.infer.mcmc.
    MCMC`: pass more chains and the warmup pools its statistics across them
    while every trajectory runs in lockstep.  Needs
    ``chain_method="vectorized"`` (sequential would adapt each chain
    alone); ``device`` (default ``"cuda"``) is where the ensemble runs."""

    cross_chain = True

    def __init__(self, model=None, potential_fn=None, step_size=1.0,
                 adapt_step_size=True, adapt_mass_matrix=True,
                 adapt_trajectory=True,
                 target_accept_prob=DEFAULT_TARGET_ACCEPT,
                 learning_rate=0.05, max_num_steps=256,
                 init_strategy="uniform", data_shards=None, device="cuda"):
        self.model = model
        self.potential_fn = potential_fn
        self.device = resolve_device(device)
        self._kwargs = dict(
            step_size=step_size, adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            adapt_trajectory=adapt_trajectory,
            target_accept_prob=target_accept_prob,
            learning_rate=learning_rate, max_num_steps=max_num_steps,
            init_strategy=init_strategy, data_shards=data_shards)

    def setup(self, generator, num_warmup, init_params=None, model_args=(),
              model_kwargs=None) -> KernelSetup:
        return chees_setup(
            generator, num_warmup, model=self.model,
            potential_fn=self.potential_fn if self.model is None else None,
            init_params=init_params, model_args=model_args,
            model_kwargs=model_kwargs, device=self.device, **self._kwargs)

    def init(self, generator, num_warmup, init_params=None, model_args=(),
             model_kwargs=None, num_chains=1):
        """Build the setup and initialize a ``num_chains``-wide ensemble
        from draw sources seeded by ``generator`` (after the setup's
        trace)."""
        setup = self.setup(generator, num_warmup, init_params=init_params,
                           model_args=model_args, model_kwargs=model_kwargs)
        *chain_draws, draws = split_draws(generator, num_chains + 1)
        return setup.init_fn(chain_draws, draws)
