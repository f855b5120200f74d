"""Carry a sampler state of the JAX package across to this package.

:func:`state_from_reference` takes one of the reference's states after
``jax.device_get`` (any object with the same field names whose leaves are
numpy arrays): NUTS/HMC's ``HMCState`` (one chain's, or C chains' batched
by ``vmap``), ChEES's ``ChEESState`` or MALA/RWM's ``MRWState``, with their
adaptation states.  It returns this package's
counterpart on ``device``.  Both packages flatten latents in sorted site
order, so the same ``z`` is the same point and the two evaluate the same
potential there.

The JAX key is not carried: this package's draws come from a
``torch.Generator`` or from a draw source a test injects.

:func:`lm_params_from_reference` carries a JAX ``LM``'s params tree across
leaf by leaf: both packages declare the same tree, stacked layer dims
included, and each leaf keeps its dtype (mamba2's float32 ``A_log``, ``D``,
``dt_bias`` and ``norm`` beside bfloat16 projections); it carries a JAX
``LM.init_cache``/``decode_step`` cache (KV caches; SSM states and conv
tails) the same way.  :func:`train_state_from_reference` carries a JAX train state
(``{"params", "opt": ((), AdamState(count, mu, nu)), "step"}``, the state
``repro.launch.steps.make_train_state`` builds for AdamW) across the same
way.  :func:`svi_state_from_reference` carries a JAX ``SVIState`` whose
optimizer is Adam (its params and ``AdamState(count, mu, nu)``) across the
same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.infer.ensemble import AdamState, ChEESAdaptState, ChEESState
from .core.infer.hmc import AdaptState, HMCState, stack_states
from .core.infer.hmc_util import DAState, WelfordState
from .core.infer.mala import MRWAdaptState, MRWState
from .optim import AdamState as OptAdamState

_F32 = np.float32


def _t(value, device):
    return torch.as_tensor(np.array(value)).to(device)


def _da(da) -> DAState:
    return DAState(_F32(da.x), _F32(da.x_avg), _F32(da.g_avg), int(da.t),
                   _F32(da.prox_center))


def _welford(wf, device) -> WelfordState:
    return WelfordState(_t(wf.mean, device), _t(wf.m2, device), int(wf.n))


def _ensemble_state(state, device):
    """The ensemble's per-chain tensors (shared by ChEES and MALA/RWM)."""
    z = _t(state.z, device)
    return dict(i=int(state.i), z=z,
                potential_energy=_t(state.potential_energy, device).to(z.dtype),
                z_grad=_t(state.z_grad, device),
                accept_prob=_t(state.accept_prob, device).to(z.dtype),
                mean_accept_prob=_t(state.mean_accept_prob,
                                    device).to(z.dtype),
                diverging=_t(state.diverging, device).to(torch.bool))


def _row(tree, c):
    """Chain ``c`` of a reference state batched by ``vmap``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_row(v, c) for v in tree))
    return np.asarray(tree)[c]


def state_from_reference(state, device="cpu"):
    """The port's ``HMCState``, ``ChEESState`` or ``MRWState`` holding the
    reference state's values.  A NUTS/HMC state batched over chains by
    ``vmap`` (its ``i`` has a chain axis) becomes the port's batched state
    (``hmc.stack_states``)."""
    device = torch.device(device)
    adapt = state.adapt_state
    if hasattr(adapt, "window_idx") and np.ndim(state.i) == 1:
        return stack_states([state_from_reference(_row(state, c), device)
                             for c in range(np.shape(state.i)[0])])
    if hasattr(adapt, "log_traj"):   # ChEES
        fields = _ensemble_state(state, device)
        adam = adapt.adam_state
        port_adapt = ChEESAdaptState(
            step_size=_F32(adapt.step_size),
            inverse_mass_matrix=_t(adapt.inverse_mass_matrix, device),
            da_state=_da(adapt.da_state), log_traj=_F32(adapt.log_traj),
            adam_state=AdamState(_F32(adam.m), _F32(adam.v), int(adam.t)),
            welford=_welford(adapt.welford, device))
        return ChEESState(
            energy=_t(state.energy, device).to(fields["z"].dtype),
            num_steps=int(state.num_steps), adapt_state=port_adapt, **fields)
    if not hasattr(adapt, "window_idx"):   # MALA / RWM
        port_adapt = MRWAdaptState(
            step_size=_F32(adapt.step_size),
            inverse_mass_matrix=_t(adapt.inverse_mass_matrix, device),
            da_state=_da(adapt.da_state),
            welford=_welford(adapt.welford, device))
        return MRWState(adapt_state=port_adapt,
                        **_ensemble_state(state, device))
    z = _t(state.z, device)
    port_adapt = AdaptState(
        step_size=_t(adapt.step_size, device).to(z.dtype),
        inverse_mass_matrix=_t(adapt.inverse_mass_matrix, device),
        da_state=_da(adapt.da_state),
        welford=_welford(adapt.welford, device),
        window_idx=int(adapt.window_idx))
    return HMCState(
        i=int(state.i), z=z,
        potential_energy=_t(state.potential_energy, device).to(z.dtype),
        z_grad=_t(state.z_grad, device),
        energy=_F32(state.energy), num_steps=int(state.num_steps),
        accept_prob=_F32(state.accept_prob),
        mean_accept_prob=_F32(state.mean_accept_prob),
        diverging=bool(state.diverging), adapt_state=port_adapt)


def _leaf_tensor(value, device):
    array = np.asarray(value)
    if array.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(array.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(array.copy()).to(device)


def lm_params_from_reference(tree, device="cpu"):
    """The port's LM params holding the values of a JAX ``LM``'s params
    (after ``jax.device_get``: nested dicts of numpy arrays), same keys,
    shapes and dtypes, on ``device``.  A JAX ``LM.init_cache`` decode cache
    carries across the same way, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: lm_params_from_reference(v, device)
                for k, v in tree.items()}
    return _leaf_tensor(tree, torch.device(device))


def train_state_from_reference(state, device="cpu"):
    """The port's train state holding a JAX AdamW train state's values
    (after ``jax.device_get``): params, the clip's empty state and the Adam
    count and moments, and the step as host ints."""
    clip, adam = state["opt"]
    return {"params": lm_params_from_reference(state["params"], device),
            "opt": (tuple(clip), OptAdamState(
                int(adam.count), lm_params_from_reference(adam.mu, device),
                lm_params_from_reference(adam.nu, device))),
            "step": int(state["step"])}


def svi_state_from_reference(state, device="cpu"):
    """The port's ``SVIState`` holding a JAX ``SVIState``'s values (after
    ``jax.device_get``): the params and the Adam count and moments, each
    leaf with its dtype, on ``device``.  The JAX key cannot be carried (a
    threefry key is no Philox state): the state's ``rng`` is that of a new
    CPU generator seeded with 0."""
    from .core.infer.svi import SVIState
    adam = state.opt_state
    return SVIState(
        lm_params_from_reference(state.params, device),
        OptAdamState(int(adam.count),
                     lm_params_from_reference(adam.mu, device),
                     lm_params_from_reference(adam.nu, device)),
        torch.Generator().manual_seed(0).get_state())
