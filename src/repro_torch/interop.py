"""Carry a chain state of the JAX package across to this package.

:func:`state_from_reference` takes the reference's ``HMCState`` (with its
``AdaptState``) after ``jax.device_get`` — any object with the same field
names whose leaves are numpy arrays — and returns this package's
:class:`~repro_torch.core.infer.hmc.HMCState` on ``device``.  Both packages
flatten latents in sorted site order, so the same ``z`` is the same point
and the two evaluate the same potential there.

The JAX key is not carried: this package's draws come from a
``torch.Generator`` or from a draw source a test injects.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.infer.hmc import AdaptState, HMCState
from .core.infer.hmc_util import DAState, WelfordState

_F32 = np.float32


def _t(value, device):
    return torch.as_tensor(np.array(value)).to(device)


def state_from_reference(state, device="cpu") -> HMCState:
    """The port's ``HMCState`` holding the reference state's values."""
    device = torch.device(device)
    adapt = state.adapt_state
    da = adapt.da_state
    wf = adapt.welford
    z = _t(state.z, device)
    port_adapt = AdaptState(
        step_size=_t(adapt.step_size, device).to(z.dtype),
        inverse_mass_matrix=_t(adapt.inverse_mass_matrix, device),
        da_state=DAState(_F32(da.x), _F32(da.x_avg), _F32(da.g_avg),
                         int(da.t), _F32(da.prox_center)),
        welford=WelfordState(_t(wf.mean, device), _t(wf.m2, device),
                             int(wf.n)),
        window_idx=int(adapt.window_idx))
    return HMCState(
        i=int(state.i), z=z,
        potential_energy=_t(state.potential_energy, device).to(z.dtype),
        z_grad=_t(state.z_grad, device),
        energy=_F32(state.energy), num_steps=int(state.num_steps),
        accept_prob=_F32(state.accept_prob),
        mean_accept_prob=_F32(state.mean_accept_prob),
        diverging=bool(state.diverging), adapt_state=port_adapt)
