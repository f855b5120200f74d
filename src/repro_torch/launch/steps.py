"""Step factories (the port of ``repro/launch/steps.py``): ``train_step``
(MAP on the log-joint, microbatched, mixed precision), ``prefill_step`` and
``serve_step``.

The paper's machinery is in the hot path: the log-prior flows through the
handler stack (``core.bayes.log_prior``) and ``serve_step`` draws the next
token through a ``sample`` site, the predictive pattern of the paper's
Fig. 1.  Where the JAX package donates the train state to its compiled
step, ``train_step`` writes the parameters in place.  The mesh-sharded
variants (``grad_shardings``, ``shard_accum``) and the dry-run input specs
wait for the multi-GPU item of the port (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import optim
from ..core import bayes, dist
from ..core.errors import pending
from ..core.primitives import sample
from ..models import LM, ModelConfig
from ..optim import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    optimizer: str = "adamw"        # adamw | adamw-bf16 | adafactor
    num_microbatches: int = 1
    accum_dtype: str = "float32"
    clip_norm: float = 1.0
    prior_sigma: float = 10.0       # MAP prior (~ decoupled weight decay)
    bias_update_rate: float = 1e-3  # DeepSeek aux-free router-bias step
    shard_accum: bool = False       # multi-GPU: not ported (RPL501)


def default_hparams(cfg: ModelConfig, shape=None) -> TrainHParams:
    """Per-arch memory-aware defaults (the JAX package's, keyed on the
    architecture's name and a shape with ``kind`` and ``global_batch``)."""
    big = cfg.name.split("-")[0] in ("deepseek", "kimi", "llama3")
    mid = cfg.name.split("-")[0] in ("jamba", "qwen1.5", "pixtral")
    mb = 1
    if shape is not None and shape.kind == "train":
        if big:
            mb = 16
        elif mid:
            mb = 8
        elif shape.global_batch >= 256:
            mb = 4
    return TrainHParams(
        optimizer=("adafactor" if big else
                   "adamw-bf16" if mid else "adamw"),
        num_microbatches=mb,
        accum_dtype="bfloat16" if big else "float32",
    )


def make_optimizer(hp: TrainHParams):
    sched = optim.warmup_cosine(hp.learning_rate, hp.warmup_steps,
                                hp.total_steps)
    # weight decay is 0: regularization comes from the MAP prior (the
    # handler-scored log p(w) in the loss), with no double counting
    if hp.optimizer == "adafactor":
        base = optim.adafactor(hp.learning_rate)
    elif hp.optimizer == "adamw-bf16":
        base = optim.adamw(hp.learning_rate, weight_decay=0.0, schedule=sched,
                           mu_dtype=torch.bfloat16, nu_dtype=torch.bfloat16)
    else:
        base = optim.adamw(hp.learning_rate, weight_decay=0.0, schedule=sched)
    return optim.chain(optim.clip_by_global_norm(hp.clip_norm), base)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_train_step(lm: LM, hp: TrainHParams, total_tokens: int,
                    grad_shardings=None):
    """``train_step(state, batch) -> (state, metrics)``: the MAP loss
    ``loss - log_prior / total_tokens`` and its gradient over every leaf
    (``torch.autograd.grad``), accumulated over ``num_microbatches`` in
    ``accum_dtype``, then clipped and fed to the optimizer; the parameters
    are updated in place.  ``metrics`` (0-dim tensors on the card) are the
    JAX package's (``ce``, ``z_loss``, ``log_prior``, ``loss`` the MAP
    loss) plus ``grad_norm``, the norm the clip reads."""
    if grad_shardings is not None or hp.shard_accum:
        raise pending("sharded gradient accumulation (grad_shardings, "
                      "shard_accum)", "multi-GPU")
    cfg = lm.cfg
    opt = make_optimizer(hp)
    accum_dtype = getattr(torch, hp.accum_dtype)
    n_mb = hp.num_microbatches

    def loss_fn(w, mb):
        loss, metrics = lm.forward(w, mb)
        # MAP: the Normal prior over weights, scored through the handler
        # stack; elementwise, no extra matrix products
        lp = bayes.log_prior(w, hp.prior_sigma)
        loss = loss - lp / total_tokens
        return loss, dict(metrics, log_prior=lp)

    def grad_fn(w, mb):
        wg = tree_map(lambda p: p.detach().requires_grad_(), w)
        loss, metrics = loss_fn(wg, mb)
        leaves = tree_leaves(wg)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, _unflatten(w, grads)

    def train_step(state, batch):
        w = state["params"]
        if n_mb == 1:
            loss, metrics, grads = grad_fn(w, batch)
        else:
            grads = metrics = None
            for i in range(n_mb):
                mb = {k: v.chunk(n_mb, 0)[i] for k, v in batch.items()}
                l, m, g = grad_fn(w, mb)
                m = dict(m, loss=l)
                if grads is None:
                    grads = tree_map(lambda a: a.to(accum_dtype), g)
                    metrics = {k: v / n_mb for k, v in m.items()}
                else:
                    tree_map(lambda a, b: a.add_(b.to(accum_dtype)), grads, g)
                    metrics = {k: metrics[k] + v / n_mb for k, v in m.items()}
                del g
            tree_map(lambda a: a.div_(n_mb), grads)
            loss = metrics["loss"]
        metrics = dict(metrics, grad_norm=optim.global_norm(grads))
        updates, opt_state = opt.update(grads, state["opt"], w)
        del grads
        _apply_in_place(w, updates)
        w = _router_bias_update(cfg, w, metrics, hp.bias_update_rate)
        return {"params": w, "opt": opt_state,
                "step": state["step"] + 1}, dict(metrics, loss=loss)

    return train_step


def _unflatten(tree, leaves):
    """A tree shaped as ``tree`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def _apply_in_place(params, updates):
    """``optim.apply_updates``, writing each parameter in place (where the
    JAX package donates the state) and releasing each float32 update once
    applied."""
    for key in list(updates):
        p, u = params[key], updates.pop(key)
        if isinstance(p, dict):
            _apply_in_place(p, u)
        else:
            p.copy_((p.float() + u).to(p.dtype))


def _router_bias_update(cfg, w, metrics, rate):
    """DeepSeek-V3's aux-free load balancing: the identity for the dense
    and softmax-routed configurations this port builds."""
    if cfg.router_type == "sigmoid":
        raise pending("the aux-free router-bias update (sigmoid router)",
                      "MoE/MLA/enc-dec")
    return w


def make_train_state(lm: LM, hp: TrainHParams, rng=0, device="cuda"):
    """``{"params", "opt", "step"}``: params drawn from ``rng`` (see
    ``LM.init``) on ``device`` (default the card)."""
    opt = make_optimizer(hp)
    w = lm.init(rng, device=device)
    return {"params": w, "opt": opt.init(w), "step": 0}


def make_prefill_step(lm: LM):
    def prefill_step(w, batch):
        return lm.forward(w, batch, return_logits="last")
    return prefill_step


def make_serve_step(lm: LM, temperature: float = 1.0,
                    return_logits: bool = False):
    """``serve_step(w, cache, tokens (B, 1), pos, generator) -> (next (B, 1)
    int32, cache)``, plus the step's logits (B, V) when ``return_logits``.
    ``pos`` is a host int; the cache is written in place.  The draw's
    uniforms come from ``generator`` (a CPU generator: ``Categorical``
    draws them on the host)."""
    def serve_step(w, cache, tokens, pos, generator: torch.Generator):
        logits, cache = lm.decode_step(w, tokens, cache, pos)
        nxt = sample("next_token",
                     dist.Categorical(logits=logits / temperature),
                     generator=generator)
        nxt = nxt[:, None].to(torch.int32)
        return (nxt, cache, logits) if return_logits else (nxt, cache)
    return serve_step
