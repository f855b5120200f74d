"""Automatic variational guides: the JAX package's
``repro.core.infer.autoguide``, ported."""
from __future__ import annotations

import torch

from .. import dist as _dist
from ..primitives import param, sample
from .hmc_util import split_draws, to_device
from .util import get_model_transforms


class AutoNormal:
    """Mean-field normal guide on the unconstrained space of each latent.

    Its params are ``{prefix}_{name}_loc`` (zeros) and
    ``{prefix}_{name}_scale`` (the log of the scale, ``log(init_scale)``),
    in the dtype and on the device of the latent's unconstrained value."""

    def __init__(self, model, prefix="auto", init_scale=0.1):
        self.model = model
        self.prefix = prefix
        self.init_scale = init_scale
        self._transforms = None
        self._protos = None

    def _setup(self, *args, **kwargs):
        if self._transforms is None:
            transforms, tr = get_model_transforms(self.model, args, kwargs)
            # sites marked auxiliary (e.g. by another guide's machinery or an
            # infer_config handler) are not model latents to be fit
            transforms = {
                n: t for n, t in transforms.items()
                if not tr[n]["infer"].get("is_auxiliary")
            }
            # local latents inside a *subsampled* plate have no meaningful
            # mean-field fit: the model redraws a different minibatch each
            # step while the guide's fixed minibatch-sized parameters would
            # be scored against arbitrary rows. (Subsampled plates are
            # recognizable as recorded "plate" sites — full-size plates emit
            # no message.)
            subsampled = {name for name, site in tr.items()
                          if site["type"] == "plate"}
            for n in transforms:
                hit = [f.name for f in tr[n]["cond_indep_stack"]
                       if f.name in subsampled]
                if hit:
                    raise ValueError(
                        f"AutoNormal cannot fit local latent '{n}' inside "
                        f"subsampled plate(s) {hit}: each SVI step draws a "
                        "different minibatch, so fixed minibatch-sized "
                        "parameters would be scored against arbitrary data "
                        "rows. Use a full-size plate for local latents, or "
                        "write an amortized guide")
            self._transforms = transforms
            # shape, dtype and device of each latent's unconstrained value
            self._protos = {
                n: transforms[n].inv(tr[n]["value"]).detach()
                for n in transforms
            }

    def __call__(self, *args, **kwargs):
        self._setup(*args, **kwargs)
        result = {}
        for name, t in self._transforms.items():
            proto = self._protos[name]
            shape = tuple(proto.shape)
            loc = param(f"{self.prefix}_{name}_loc", torch.zeros_like(proto))
            log_scale = param(
                f"{self.prefix}_{name}_scale",
                torch.full_like(proto, float(torch.log(torch.tensor(
                    self.init_scale, dtype=proto.dtype)))))
            base = _dist.Normal(loc, torch.exp(log_scale))
            if len(shape):
                base = base.to_event(len(shape))
            u = sample(f"{self.prefix}_{name}_base", base,
                       infer={"is_auxiliary": True})
            value = t(u)
            # score the latent under a Delta carrying -log|det J| so the
            # guide density on the constrained value is exact; spread the
            # scalar total evenly so summing over event dims reproduces it
            ladj_total = -torch.sum(t.log_abs_det_jacobian(u, value))
            size = max(value.numel(), 1)
            ld_elem = (ladj_total / size).broadcast_to(value.shape)
            result[name] = sample(
                name, _dist.Delta(value, log_density=ld_elem,
                                  event_dim=value.dim()))
        return result

    def median(self, params):
        out = {}
        for name, t in self._transforms.items():
            loc = params[f"{self.prefix}_{name}_loc"]
            out[name] = t(loc)
        return out

    def sample_posterior(self, generator, params, num_samples=1000):
        """``num_samples`` draws of each latent from the fitted guide: one
        generator split from ``generator`` per site (in the guide's order),
        standard normals drawn on the CPU and moved to the params'
        device."""
        out = {}
        gens = [d.generator for d in split_draws(generator,
                                                 len(self._transforms))]
        for gen, (name, t) in zip(gens, self._transforms.items()):
            loc = params[f"{self.prefix}_{name}_loc"]
            scale = torch.exp(params[f"{self.prefix}_{name}_scale"])
            eps = torch.randn((num_samples,) + tuple(loc.shape),
                              generator=gen, dtype=loc.dtype)
            out[name] = t(loc + scale * to_device(eps, loc.device))
        return out


__all__ = ["AutoNormal"]
