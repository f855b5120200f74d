"""Stochastic Variational Inference (paper Sec. 3.2 / Appendix D): the JAX
package's ``repro.core.infer.svi``, ported.

Differences from the JAX package, by design:

- Random keys are CPU ``torch.Generator``s.  ``SVIState.rng`` holds the
  generator's state as a tensor (``Generator.get_state()``), so a state is
  plain data; a split is two 62-bit seeds drawn from a generator
  (``hmc_util.split_draws``).
- ``Trace_ELBO(num_particles > 1)`` loops over the particles, each with its
  own sub-generator, where the JAX package ``vmap``\\ s over split keys.
- ``SVI.update`` is pure: it never writes into its input state.  It takes
  the gradient with ``torch.autograd.grad`` on fresh leaf tensors of the
  params and applies the optimizer's functional ``update``, ``params +
  updates`` as the JAX package's SVI adds them (not
  ``optim.apply_updates``, which rounds a float64 param through float32).
  So ``evaluate(state)`` gives exactly the loss the next ``update(state)``
  reports.
- ``SVI.run`` is a Python loop of ``update`` (the JAX package's
  ``lax.scan``); the losses stay on the device, stacked once at the end,
  with no read back to the host per step.
- The model arguments are moved to the SVI's ``device`` (default
  ``"cuda"``; ``resolve_device`` raises without a card), as ``MCMC.run``
  moves them.  Draws are made on the CPU and moved to the parameters'
  device, so a seed gives the same steps on every device.
- ``validate=True`` lints the model and the guide once, in ``init``, on
  the arguments as moved to the device (:func:`repro_torch.lint.lint_model`):
  warnings surface as warnings, errors raise with their ``RPL`` code;
  ``update`` never lints.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..handlers import _as_generator, replay, seed, trace
from .hmc import resolve_device
from .hmc_util import split_draws
from .mcmc import _to_device
from .util import log_density


class Trace_ELBO:
    """Monte Carlo ELBO.  Both the model and guide densities flow through
    the unified :func:`~repro_torch.core.infer.util.log_density`, so plate
    ``size / subsample_size`` scaling (and ``scale``/``mask`` handlers)
    apply automatically: a model that draws a random minibatch through
    ``plate(..., subsample_size=B)`` and ``subsample`` gives an unbiased
    estimate of the full-data ELBO, with a fresh minibatch per step drawn
    from the step's generator.  ``num_particles > 1`` takes the mean over
    particles, one sub-generator each, one after another."""

    def __init__(self, num_particles: int = 1):
        self.num_particles = num_particles

    def loss(self, generator, param_map, model, guide, *args, **kwargs):
        """Negative ELBO at ``param_map`` (name -> tensor), drawing from
        ``generator`` (a CPU ``torch.Generator``): for each particle two
        generators split from it, the model's then the guide's; the guide
        is seeded, traced and scored, the seeded model replayed on the
        guide's trace and scored."""
        def single(gen):
            gen_model, gen_guide = (d.generator for d in split_draws(gen, 2))
            guide_log_density, guide_trace = log_density(
                seed(guide, gen_guide), args, kwargs, param_map)
            replayed = replay(seed(model, gen_model), guide_trace=guide_trace)
            model_log_density, _ = log_density(replayed, args, kwargs,
                                               param_map)
            return model_log_density - guide_log_density

        if self.num_particles == 1:
            return -single(generator)
        return -torch.mean(torch.stack(
            [single(d.generator)
             for d in split_draws(generator, self.num_particles)]))


class SVIState(NamedTuple):
    params: dict
    opt_state: tuple
    rng: torch.Tensor  # the state of a CPU torch.Generator


class SVI:
    """Stochastic variational inference in pure steps: ``init`` ->
    ``update`` -> ``update`` ...

    Models that subsample internally (``plate(..., subsample_size=B)``)
    take the full data every step; the plate draws a fresh random minibatch
    from the step's generator.
    """

    def __init__(self, model, guide, optim, loss: Trace_ELBO,
                 validate: bool = False, device=None):
        self.model = model
        self.guide = guide
        self.optim = optim
        self.loss = loss
        # validate=True lints model and guide once, in init(): never in
        # update, so it cannot affect a step
        self.validate = bool(validate)
        self.device = resolve_device(device if device is not None
                                     else "cuda")

    def _validate(self, args, kwargs):
        import warnings

        from ..lint import lint_model
        for label, fn in (("model", self.model), ("guide", self.guide)):
            result = lint_model(fn, args, kwargs, device=self.device)
            for finding in result.warnings:
                warnings.warn(f"{label}: {finding}", stacklevel=3)
            result.raise_if_errors()

    def _args(self, args, kwargs):
        return _to_device(args, self.device), _to_device(kwargs, self.device)

    def init(self, generator, *args, **kwargs):
        """The first state: the param sites of model and guide, traced once
        each under generators with one state (the JAX package's
        ``key_init``), their values as the params, the optimizer's initial
        state and the rest of the generator (``key_state``)."""
        args, kwargs = self._args(args, kwargs)
        if self.validate:
            self._validate(args, kwargs)
        key_init, key_state = (
            d.generator for d in split_draws(_as_generator(generator), 2))
        init_state = key_init.get_state()
        params = {}
        for fn in (self.model, self.guide):
            tr = trace(seed(fn, torch.Generator().set_state(init_state))
                       ).get_trace(*args, **kwargs)
            for name, site in tr.items():
                if site["type"] == "param":
                    params[name] = site["value"].detach()
        opt_state = self.optim.init(params)
        return SVIState(params, opt_state, key_state.get_state())

    def _loss(self, params, rng_state, args, kwargs):
        """The loss at ``params`` from a state's generator: ``(its next
        state, loss)``."""
        key, key_loss = (d.generator for d in split_draws(
            torch.Generator().set_state(rng_state), 2))
        loss = self.loss.loss(key_loss, params, self.model, self.guide,
                              *args, **kwargs)
        return key.get_state(), loss

    def update(self, state: SVIState, *args, **kwargs):
        """One step -> ``(new state, loss)``; ``state`` is left as it was."""
        args, kwargs = self._args(args, kwargs)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        rng, loss = self._loss(params, state.rng, args, kwargs)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        updates, opt_state = self.optim.update(grads, state.opt_state,
                                               state.params)
        new_params = {k: state.params[k] + updates[k] for k in names}
        return SVIState(new_params, opt_state, rng), loss.detach()

    def run(self, generator, num_steps, *args, **kwargs):
        """``init`` then ``num_steps`` updates -> ``(state, losses)``, the
        losses a ``(num_steps,)`` tensor on the device."""
        args, kwargs = self._args(args, kwargs)
        state = self.init(generator, *args, **kwargs)
        losses = []
        for _ in range(num_steps):
            state, loss = self.update(state, *args, **kwargs)
            losses.append(loss)
        return state, (torch.stack(losses) if losses
                       else torch.zeros(0, device=self.device))

    def evaluate(self, state: SVIState, *args, **kwargs):
        """Loss at the current params without advancing the state: the
        state's loss generator, so exactly the loss the next ``update``
        reports."""
        args, kwargs = self._args(args, kwargs)
        with torch.no_grad():
            return self._loss(state.params, state.rng, args, kwargs)[1]

    def get_params(self, state: SVIState):
        return state.params


__all__ = ["SVI", "SVIState", "Trace_ELBO"]
