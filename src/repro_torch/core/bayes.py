"""The paper's handlers applied at LLM scale (the port of
``repro/core/bayes.py``).

``log_prior`` evaluates the sum of log p(w) for a Normal prior over every
weight matrix *through the effect-handler stack*: the weights become
observed ``sample`` sites of a prior model and the log-joint is read off a
``trace``, the machinery that scores a logistic regression.  MAP ascent on
``log p(tokens | w) + log p(w)`` is then exactly weight-decay-regularized
training (the prior term is elementwise: no extra matrix products).

``lift`` turns ``param`` sites into latent ``sample`` sites (Pyro's
``random_module``), giving fully Bayesian variants of a model.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..distributed.sharding import replicate
from . import dist
from .handlers import Messenger, trace
from .infer.util import _SupportChecked
from .primitives import sample


def _flatten_with_path(tree, path=()):
    """(path, leaf) pairs in ``jax.tree_util``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_path(tree[key], path + (key,))
    else:
        yield path, tree


def log_prior(params, sigma: float = 1.0, min_ndim: int = 2):
    """Joint log density (a 0-dim float32 tensor) of a Normal(0, sigma)
    prior over the weight leaves with ``ndim >= min_ndim`` (norm scales and
    biases are excluded, matching the no-decay-on-norms convention);
    differentiable in the leaves.  A DTensor leaf (a parameter on a mesh)
    is scored on each rank's shard against a replicated prior, and the
    total is the mesh's sum."""

    def prior_model():
        for path, leaf in _flatten_with_path(params):
            if leaf.dim() < min_ndim:
                continue
            zero = torch.zeros((), dtype=torch.float32, device=leaf.device)
            if isinstance(leaf, DTensor):
                zero = DTensor.from_local(
                    zero, leaf.device_mesh,
                    [Replicate()] * leaf.device_mesh.ndim, run_check=False)
            sample("/".join(path),
                   dist.Normal(zero, zero + sigma).expand(leaf.shape)
                   .to_event(leaf.dim()),
                   obs=leaf.float())

    # the values are the parameters themselves: checking their support
    # would read every leaf back to the host (the JAX package skips the
    # check for the traced values of its compiled train step)
    with _SupportChecked():
        tr = trace(prior_model).get_trace()
    lp = None
    for name in list(tr):  # each float32 copy is released once scored
        site = tr.pop(name)
        if site["type"] == "sample":
            term = replicate(torch.sum(site["fn"].log_prob(site["value"])))
            lp = term if lp is None else lp + term
    return torch.zeros(()) if lp is None else lp


class lift(Messenger):
    """Reinterpret ``param`` sites as latent ``sample`` sites under
    ``prior_fn`` (a map from the param message to a Distribution), making
    the model fully Bayesian (Pyro's random_module as an effect
    handler)."""

    def __init__(self, fn=None, prior_fn=None):
        super().__init__(fn)
        self.prior_fn = prior_fn or (
            lambda msg: dist.Normal(0.0, 1.0)
            .expand(msg["kwargs"]["shape"])
            .to_event(len(msg["kwargs"]["shape"])))

    def process_message(self, msg):
        if msg["type"] != "param":
            return
        msg["type"] = "sample"
        msg["fn"] = self.prior_fn(msg)
        msg["is_observed"] = False
        msg["kwargs"] = {"generator": msg["kwargs"].get("generator"),
                         "sample_shape": ()}
