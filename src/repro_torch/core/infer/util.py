"""Inference utilities: log densities, transforms to unconstrained space,
the flat potential and model initialization (paper Sec 3.2).

Latent sites are flattened into one vector in *sorted site-name order*, the
order of ``jax.flatten_util.ravel_pytree`` on a dict, so a flat ``z`` means
the same point in this package and in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..dist.transforms import biject_to
from ..errors import pending
from ..handlers import Messenger, block, seed, substitute, trace


class _SupportChecked(Messenger):
    """Mark every sample site as already support-checked.  The sampler's
    potential re-runs the model at every gradient; its data was checked
    once when the model was traced at setup, and checking again would read
    the observations back to the host on every call."""

    def process_message(self, msg: dict) -> None:
        if msg["type"] == "sample":
            msg["support_checked"] = True


def _probe_enumeration(model, model_args, model_kwargs, params):
    """The enum-aware ``log_density``'s first, inert pass: returns the trace
    and, when some site requests enumeration (or a ``markov`` chain runs),
    the ``first_available_dim`` of the enumeration pass; else ``None``."""
    from .enum import _EnumProbe, _first_available_dim
    probe = _EnumProbe(model)
    tr = trace(substitute(probe, data=params)).get_trace(*model_args,
                                                         **model_kwargs)
    return tr, (_first_available_dim(probe) if probe.found else None)


def _enum_log_density(model, model_args, model_kwargs, params,
                      first_available_dim):
    """The enumeration pass: trace under ``enum`` and eliminate."""
    from .enum import contract_enum_factors, enum
    handler = enum(model, first_available_dim=first_available_dim)
    tr = trace(substitute(handler, data=params)).get_trace(*model_args,
                                                           **model_kwargs)
    return contract_enum_factors(tr), tr


def log_density(model, model_args, model_kwargs, params):
    """Joint log density of ``model`` at ``params`` (constrained space).

    Returns ``(log_joint, trace)``.  The single density accumulator of the
    system: only ``sample`` sites contribute, each as
    ``sum(where(mask, log_prob, 0) * scale)``.

    The accumulator is enumeration-aware, as in the JAX package: a first,
    inert probe pass detects sites marked ``infer={"enumerate":
    "parallel"}`` (or chains built with
    :func:`~repro_torch.core.infer.enum.markov`) and measures the deepest
    plate/batch dim.  If any are found, the model is traced again under an
    :class:`~repro_torch.core.infer.enum.enum` handler and the enumeration
    dims are summed out exactly by
    :func:`~repro_torch.core.infer.enum.contract_enum_factors`; otherwise the
    probe's trace is the model's and is summed directly.
    """
    from .enum import _site_log_prob
    tr, first_available_dim = _probe_enumeration(model, model_args,
                                                 model_kwargs, params)
    if first_available_dim is not None:
        return _enum_log_density(model, model_args, model_kwargs, params,
                                 first_available_dim)
    log_joint = 0.0
    for site in tr.values():
        if site["type"] == "sample":
            log_joint = log_joint + torch.sum(_site_log_prob(site))
    return log_joint, tr


def get_model_transforms(model, model_args=(), model_kwargs=None,
                         generator=None):
    """Trace the model once to discover latent sites and their bijections.

    Wrapped in ``block`` so the exploratory trace never leaks sites into an
    enclosing handler.  Enumerable discrete latents have no bijection: the
    enum-aware :func:`log_density` marginalizes them, so they are simply
    not part of the continuous latent vector.
    """
    model_kwargs = model_kwargs or {}
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    with block():
        tr = trace(seed(model, gen)).get_trace(*model_args, **model_kwargs)
    transforms = {}
    for name, site in tr.items():
        if site["type"] == "sample" and not site["is_observed"]:
            fn = site["fn"]
            if (site["infer"].get("enumerate") == "parallel"
                    or getattr(fn, "has_enumerate_support", False)):
                continue
            transforms[name] = biject_to(fn.support)
    return transforms, tr


def transform_fn(transforms, params):
    """Unconstrained site values -> constrained ones."""
    return {k: transforms[k](v) for k, v in params.items()}


def potential_energy(model, model_args, model_kwargs, transforms,
                     params_uncon, first_available_dim=None):
    """-log p(constrained(z)) - log|det J(z)| on unconstrained space.

    ``first_available_dim`` (from a probe made once at setup) skips the
    probe pass of :func:`log_density` and traces straight under ``enum``."""
    params_con = {}
    log_det = 0.0
    for name, t in transforms.items():
        u = params_uncon[name]
        x = t(u)
        params_con[name] = x
        log_det = log_det + torch.sum(t.log_abs_det_jacobian(u, x))
    if first_available_dim is None:
        log_joint, _ = log_density(model, model_args, model_kwargs,
                                   params_con)
    else:
        log_joint, _ = _enum_log_density(model, model_args, model_kwargs,
                                         params_con, first_available_dim)
    return -(log_joint + log_det)


def ravel(params: Dict[str, torch.Tensor]
          ) -> Tuple[torch.Tensor, Callable]:
    """Flatten a dict of tensors in sorted-key order (the order of
    ``jax.flatten_util.ravel_pytree``).  Returns ``(flat, unravel)``;
    ``unravel`` also takes a batch ``(..., D)`` of flat vectors and restores
    each site's shape and dtype behind the batch dims."""
    names = sorted(params)
    shapes = [tuple(params[k].shape) for k in names]
    dtypes = [params[k].dtype for k in names]
    sizes = [params[k].numel() for k in names]
    flat = torch.cat([params[k].reshape(-1) for k in names]) if names \
        else torch.zeros(0)

    def unravel(z):
        out, start = {}, 0
        lead = tuple(z.shape[:-1])
        for name, shape, dtype, size in zip(names, shapes, dtypes, sizes):
            out[name] = z[..., start:start + size].reshape(lead + shape).to(dtype)
            start += size
        return out

    return flat, unravel


def initialize_model_structure(generator, model, model_args=(),
                               model_kwargs=None):
    """One-time work: trace the model and build the flat-space closures.

    Returns ``(potential_fn_flat, unravel_fn, transforms, constrain,
    model_trace, flat_prototype)``.  A model that marks its likelihood
    ``infer={"potential": "glm"}`` gets the fused GLM potential when the
    structural checks of :mod:`repro_torch.core.infer.glm` pass.

    Models with enumerable discrete latents need no special treatment: the
    model is wrapped in :func:`~repro_torch.core.infer.enum.config_enumerate`
    (inert otherwise), those sites are left out of the continuous latent
    vector, and every potential evaluation marginalizes them.  The model's
    structure is static, so the enumeration probe runs once here and the
    potential traces each gradient under ``enum`` directly (the JAX package
    probes at every trace, which ``jit`` makes free).
    """
    from .enum import config_enumerate
    model_kwargs = model_kwargs or {}
    model = config_enumerate(model)
    transforms, tr = get_model_transforms(model, model_args, model_kwargs,
                                          generator)
    if not transforms:
        raise ValueError("model has no continuous latent sample sites")
    proto = {name: t.inv(tr[name]["value"]) for name, t in transforms.items()}
    flat_proto, unravel_fn = ravel(proto)
    checked = _SupportChecked(model)
    _, first_available_dim = _probe_enumeration(
        checked, model_args, model_kwargs,
        {name: tr[name]["value"] for name in transforms})

    def potential_flat(zflat):
        return potential_energy(checked, model_args, model_kwargs, transforms,
                                unravel_fn(zflat), first_available_dim)

    def constrain(zflat):
        return transform_fn(transforms, unravel_fn(zflat))

    from .glm import maybe_fuse_glm_potential
    fused = maybe_fuse_glm_potential(checked, model_args, model_kwargs,
                                     transforms, unravel_fn, flat_proto, tr,
                                     potential_flat)
    if fused is not None:
        potential_flat = fused
    return potential_flat, unravel_fn, transforms, constrain, tr, flat_proto


def find_valid_initial_params(draws, potential_fn, prototype, *,
                              init_strategy="uniform", radius=2.0,
                              max_tries=100, reads=None):
    """Rejection search for a flat unconstrained init with finite potential
    and gradient: draws uniform on ``[-radius, radius]^D`` from ``draws``
    until one is valid or ``max_tries`` more tries are spent (the JAX
    package's ``while_loop`` as a Python loop).  Returns ``(z, pe, grad)``.
    """
    from .hmc_util import HostReads, value_and_grad
    if init_strategy != "uniform":
        raise pending(f"init_strategy={init_strategy!r}", "initialization")
    reads = reads if reads is not None else HostReads()
    pe_and_grad = value_and_grad(potential_fn)
    for _ in range(max_tries + 1):
        u = draws.init_uniform(prototype.numel(), prototype.dtype)
        z = (u * (2 * radius) - radius).to(prototype.device)
        pe, grad = pe_and_grad(z)
        ok = torch.isfinite(pe) & torch.all(torch.isfinite(grad))
        if reads.read(ok.reshape(1))[0]:
            break
    return z, pe, grad
