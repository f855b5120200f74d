"""Batched MALA and random-walk Metropolis over a (C, D) ensemble.

The port of the JAX package's ``core/infer/mala.py``.  Both samplers are
cross-chain kernels: the whole ensemble moves through one
``ops.mala_step`` launch per iteration, and warmup pools across chains as
ChEES does (one dual-averaging run on the harmonic-mean accept probability,
one pooled Welford estimator feeding the shared diagonal preconditioner).

MALA proposal (preconditioner ``M^{-1}`` diagonal, step ``eps``)::

    z' = z - eps * M^{-1} grad U(z) + sqrt(2 eps M^{-1}) xi

with the exact Metropolis-Hastings correction: the forward density from the
drawn ``xi``, the reverse one from the gradient at ``z'`` that the next
iteration needs anyway.  RWM drops the drift term (and the kernel's
gradient operand); its proposal is symmetric, so the correction is the
potential difference.  Targets 0.574 (MALA) and 0.234 (RWM), after Roberts
& Rosenthal; a non-finite proposal potential is a divergence, always
rejected.  After the potential at the proposal, one ``ops.mala_accept``
launch does the whole accept step: the correction, the test, the selection
and the iteration's accept statistics.

As in :mod:`~repro_torch.core.infer.ensemble`, the step size and dual
averaging live on the host in float32: a warmup iteration reads the
harmonic-mean accept probability back once, a sampling iteration reads
nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...kernels import ops
from .ensemble import initial_positions, refresh_mass
from .hmc import (counting, flat_model_ingredients, resolve_data_axis,
                  resolve_device)
from .hmc_util import (
    DAState,
    HostReads,
    WelfordState,
    build_adaptation_schedule,
    chain_value_and_grad,
    dual_averaging_init,
    dual_averaging_update,
    split_draws,
    to_device,
    welford_batch,
    welford_combine,
    welford_init,
    window_predicates,
)
from .kernel_api import KernelSetup

_F32 = np.float32

# optimal acceptance rates (Roberts & Rosenthal): MALA scales like d^{-1/3}
# at 0.574, the random walk like d^{-1} at 0.234
DEFAULT_TARGET_ACCEPT = {"MALA": 0.574, "RWM": 0.234}


class MRWAdaptState(NamedTuple):
    """Shared (cross-chain) adaptation state; scalars on the host."""
    step_size: np.float32              # shared by every chain
    inverse_mass_matrix: torch.Tensor  # (D,) diagonal preconditioner
    da_state: DAState                  # dual averaging on the mean accept
    welford: WelfordState              # pooled (D,) estimator, all chains


class MRWState(NamedTuple):
    """The ensemble: per-chain tensors lead with the chain axis C.  For RWM
    ``z_grad`` keeps the initial gradient (the proposal never reads it)."""
    i: int
    z: torch.Tensor                    # (C, D) flat unconstrained positions
    potential_energy: torch.Tensor     # (C,)
    z_grad: torch.Tensor               # (C, D)
    accept_prob: torch.Tensor          # (C,)
    mean_accept_prob: torch.Tensor     # (C,) running post-warmup mean
    diverging: torch.Tensor            # (C,) bool
    adapt_state: MRWAdaptState


def _make_init_fn(potential_fn, prototype, reads, *, z_fixed, step_size0,
                  init_strategy):
    """Batch init: per-chain position search, then the shared scalars: the
    initial step size as given (dual averaging owns it from the first
    warmup iteration), unit preconditioner."""
    dim = prototype.numel()

    def init_fn(chain_draws, draws):
        z, pe, grad = initial_positions(
            potential_fn, prototype, chain_draws, reads, z_fixed=z_fixed,
            init_strategy=init_strategy)
        num_chains = z.shape[0]
        step_size = _F32(step_size0)
        adapt = MRWAdaptState(
            step_size=step_size,
            inverse_mass_matrix=torch.ones(dim, dtype=z.dtype,
                                           device=z.device),
            da_state=dual_averaging_init(np.log(step_size)),
            welford=welford_init(dim, z.dtype, z.device))
        zeros = z.new_zeros(num_chains)
        return MRWState(
            i=0, z=z, potential_energy=pe, z_grad=grad, accept_prob=zeros,
            mean_accept_prob=zeros,
            diverging=torch.zeros(num_chains, dtype=torch.bool,
                                  device=z.device),
            adapt_state=adapt)

    return init_fn


def _make_sample_fn(potential_fn, num_warmup, schedule, algo, reads, *,
                    adapt_step_size, adapt_mass_matrix, target_accept_prob):
    """The ensemble transition ``(MRWState, draws) -> MRWState``."""
    in_middle_window, window_end_is_middle = window_predicates(schedule)
    pe_and_grad = chain_value_and_grad(potential_fn)
    use_grad = algo == "MALA"

    def adapt_update(adapt: MRWAdaptState, t, z_next,
                     hmean) -> MRWAdaptState:
        da, step_size = adapt.da_state, adapt.step_size
        if adapt_step_size:  # the one host read of a warmup iteration
            hmean = reads.read(hmean.reshape(1))[0]
            da = dual_averaging_update(
                da, _F32(target_accept_prob) - _F32(hmean))
            step_size = _F32(np.exp(da.x))
        imm, wf = adapt.inverse_mass_matrix, adapt.welford
        if adapt_mass_matrix:
            if in_middle_window(t):
                wf = welford_combine(wf, welford_batch(z_next))
            if window_end_is_middle(t):
                imm, wf, da, step_size = refresh_mass(wf, da, step_size,
                                                      adapt_step_size)
        if adapt_step_size and t == num_warmup - 1:
            step_size = _F32(np.exp(da.x_avg))
        return MRWAdaptState(step_size, imm, da, wf)

    def sample_fn(state: MRWState, draws) -> MRWState:
        num_chains, dim = state.z.shape
        adapt = state.adapt_state
        minv, eps = adapt.inverse_mass_matrix, adapt.step_size
        noise = to_device(draws.noise(num_chains, dim, state.z.dtype),
                          state.z.device)
        z_new = ops.mala_step(state.z, state.z_grad if use_grad else None,
                              noise, minv, float(eps))
        pe_new, grad_new = pe_and_grad(z_new)
        u = to_device(draws.accept_uniforms(num_chains, state.z.dtype),
                      state.z.device)
        t = state.i
        # 0 in warmup (then the harmonic-mean accept prob comes back too),
        # else the post-warmup count of the running mean
        n_post = max(t + 1 - num_warmup, 0)
        z, pe, grad, accept_prob, diverging, mean_ap, hmean = \
            ops.mala_accept(
                state.z, state.potential_energy,
                state.z_grad if use_grad else None, z_new, pe_new,
                grad_new if use_grad else None, noise if use_grad else None,
                minv, u, float(eps), float(_F32(-0.25) / eps),
                state.mean_accept_prob, n_post)
        if not use_grad:
            grad = state.z_grad
        new_adapt = adapt_update(adapt, t, z, hmean) if n_post == 0 \
            else adapt
        return MRWState(t + 1, z, pe, grad, accept_prob, mean_ap, diverging,
                        new_adapt)

    return sample_fn


def _collect_fn(state: MRWState):
    """Per-draw outputs; the shared host scalars broadcast over the chain
    axis (as numpy rows) so every leaf leads with C.  One proposal is one
    step."""
    num_chains = state.z.shape[0]
    return {
        "z": state.z,
        "potential_energy": state.potential_energy,
        "num_steps": np.ones(num_chains, np.int32),
        "accept_prob": state.accept_prob,
        "diverging": state.diverging,
        "step_size": np.full(num_chains, state.adapt_state.step_size,
                             np.float32),
    }


def _metrics_fn(state: MRWState):
    """The metrics stream under the cross-chain contract: the pooled step
    size (a host scalar) and the preconditioner's sum stay one value a
    draw, per-chain diagnostics are (C,).  It reads the state only."""
    adapt = state.adapt_state
    return {
        "step_size": adapt.step_size,
        "mass_trace": adapt.inverse_mass_matrix.sum(),
        "accept_prob": state.accept_prob,
        "diverging": state.diverging,
        "potential_energy": state.potential_energy,
    }


def mrw_setup(generator, num_warmup, algo, *, model=None, potential_fn=None,
              init_params=None, model_args=(), model_kwargs=None,
              step_size=0.1, adapt_step_size=True, adapt_mass_matrix=True,
              target_accept_prob=None, init_strategy="uniform",
              data_shards=None, device="cuda") -> KernelSetup:
    """Build the cross-chain :class:`KernelSetup` for MALA or RWM on
    ``device`` (default ``"cuda"``; raises without CUDA unless
    ``device="cpu"``).  ``data_shards=S`` gives the fused GLM likelihood an
    S-shard fold (``KernelSetup.data_axis``, ``RPL302`` without a
    shard-aware potential, as :func:`~repro_torch.core.infer.hmc.hmc_setup`
    does)."""
    if algo not in ("MALA", "RWM"):
        raise ValueError(f"algo must be 'MALA' or 'RWM', got {algo!r}")
    if target_accept_prob is None:
        target_accept_prob = DEFAULT_TARGET_ACCEPT[algo]
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
    init_fn = _make_init_fn(counted, prototype, reads, z_fixed=z_fixed,
                            step_size0=step_size, init_strategy=init_strategy)
    sample_fn = _make_sample_fn(
        counted, num_warmup, schedule, algo, reads,
        adapt_step_size=adapt_step_size, adapt_mass_matrix=adapt_mass_matrix,
        target_accept_prob=target_accept_prob)
    return KernelSetup(
        init_fn=init_fn, sample_fn=sample_fn, collect_fn=_collect_fn,
        potential_fn=potential_flat, unravel_fn=unravel,
        constrain_fn=constrain, num_warmup=int(num_warmup), algo=algo,
        adapt_schedule=tuple((int(s), int(e)) for (s, e) in schedule),
        host_reads=reads, grad_evals=counted, cross_chain=True,
        metrics_fn=_metrics_fn, data_axis=data_axis)


class _MRWKernel:
    """The shared class over :func:`mrw_setup`; ``device`` (default
    ``"cuda"``) is where the ensemble runs."""

    _algo = ""
    cross_chain = True

    def __init__(self, model=None, potential_fn=None, step_size=0.1,
                 adapt_step_size=True, adapt_mass_matrix=True,
                 target_accept_prob=None, init_strategy="uniform",
                 data_shards=None, device="cuda"):
        self.model = model
        self.potential_fn = potential_fn
        self.device = resolve_device(device)
        self._kwargs = dict(
            step_size=step_size, adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept_prob=target_accept_prob,
            init_strategy=init_strategy, data_shards=data_shards)

    def setup(self, generator, num_warmup, init_params=None, model_args=(),
              model_kwargs=None) -> KernelSetup:
        return mrw_setup(
            generator, num_warmup, self._algo, model=self.model,
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


class MALA(_MRWKernel):
    """Metropolis-adjusted Langevin ensemble kernel: one gradient per chain
    and draw, all chains moved by one (C, D) proposal kernel, warmup pooled
    across chains."""

    _algo = "MALA"


class RWM(_MRWKernel):
    """Random-walk Metropolis ensemble kernel: the proposal reads no
    gradient; the same pooled warmup as :class:`MALA`."""

    _algo = "RWM"
