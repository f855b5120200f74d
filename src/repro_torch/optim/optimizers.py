"""Functional optimizers (the port of ``repro/optim/optimizers.py``): the
optax-style ``GradientTransformation`` protocol over nested dicts of tensors.

The math is the JAX package's, in float32 with the same casts: moments are
kept in ``mu_dtype``/``nu_dtype`` (default: the parameter's dtype) and every
update is computed from float32 copies.  Step counts and learning-rate
schedules are host numbers computed in float32 (``numpy.float32``), so an
update issues no read back from the card.  Every function returns new
tensors; ``launch/steps.py`` writes the parameters in place.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_F32 = np.float32


# ---------------------------------------------------------------------------
# trees: nested dicts (and tuples/lists) with tensors at the leaves
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; dicts keep their keys, tuples (named too) and lists their
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in the order ``jax.tree_util`` flattens the same tree
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def global_norm(tree):
    """The float32 l2 norm of every leaf together (a 0-dim tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def chain(*transforms) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def scale(factor) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: g * factor, grads), state

    return GradientTransformation(init, update)


def scale_by_schedule(schedule: Callable) -> GradientTransformation:
    def init(params):
        return 0

    def update(grads, count, params=None):
        lr = float(schedule(count))
        return tree_map(lambda g: g * -lr, grads), count + 1

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm) -> GradientTransformation:
    def init(params):
        return ()

    def update(grads, state, params=None):
        norm = global_norm(grads)
        factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return tree_map(lambda g: (g.float() * factor).to(g.dtype),
                        grads), state

    return GradientTransformation(init, update)


def sgd(learning_rate, momentum: Optional[float] = None
        ) -> GradientTransformation:
    def init(params):
        if momentum is None:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        if momentum is None:
            return tree_map(lambda g: -learning_rate * g, grads), state
        state = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -learning_rate * m, state), state

    return GradientTransformation(init, update)


class AdamState(NamedTuple):
    count: int
    mu: dict
    nu: dict


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, mu_dtype=None,
         nu_dtype=None, schedule: Optional[Callable] = None
         ) -> GradientTransformation:
    lr_fn = schedule if schedule is not None else (lambda _: learning_rate)

    def init(params):
        mu = tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                      params)
        nu = tree_map(lambda p: torch.zeros_like(p, dtype=nu_dtype or p.dtype),
                      params)
        return AdamState(0, mu, nu)

    def update(grads, state, params=None):
        count = state.count + 1
        cf = _F32(count)
        mu = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g.float()
                                    ).to(m.dtype), state.mu, grads)
        nu = tree_map(lambda v, g: (b2 * v.float()
                                    + (1 - b2) * torch.square(g.float())
                                    ).to(v.dtype), state.nu, grads)
        bc1 = float(_F32(1) - _F32(b1) ** cf)
        bc2 = float(_F32(1) - _F32(b2) ** cf)
        lr = float(lr_fn(count))
        updates = tree_map(
            lambda m, v: (-lr * (m.float() / bc1))
            / (torch.sqrt(v.float() / bc2) + eps), mu, nu)
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          mu_dtype=None, nu_dtype=None, schedule: Optional[Callable] = None
          ) -> GradientTransformation:
    base = adam(learning_rate, b1, b2, eps, mu_dtype, nu_dtype, schedule)
    lr_fn = schedule if schedule is not None else (lambda _: learning_rate)

    def init(params):
        return base.init(params)

    def update(grads, state, params=None):
        updates, new_state = base.update(grads, state, params)
        # with no decay the term is an exact zero: skip its full-size pass
        if params is not None and weight_decay:
            lr = float(lr_fn(new_state.count))
            updates = tree_map(
                lambda u, p: u - lr * weight_decay * p.float(), updates,
                params)
        return updates, new_state

    return GradientTransformation(init, update)


class AdafactorState(NamedTuple):
    count: int
    v_row: dict
    v_col: dict
    v_full: dict  # for <2D params


def adafactor(learning_rate, decay=0.8, eps=1e-30, clip_threshold=1.0
              ) -> GradientTransformation:
    """Factored second-moment optimizer: O(n+m) state for (n,m) matrices."""

    def _factored(p):
        return p.dim() >= 2

    def _zeros(shape, like):
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    def init(params):
        v_row = tree_map(lambda p: _zeros(p.shape[:-1], p) if _factored(p)
                         else _zeros((), p), params)
        v_col = tree_map(lambda p: _zeros(p.shape[:-2] + p.shape[-1:], p)
                         if _factored(p) else _zeros((), p), params)
        v_full = tree_map(lambda p: _zeros((), p) if _factored(p)
                          else _zeros(p.shape, p), params)
        return AdafactorState(0, v_row, v_col, v_full)

    def update(grads, state, params=None):
        count = state.count + 1
        beta = float(_F32(1) - _F32(count) ** _F32(-decay))

        def upd(g, vr, vc, vf):
            g = g.float()
            g2 = torch.square(g) + eps
            if g.dim() >= 2:
                vr = beta * vr + (1 - beta) * g2.mean(-1)
                vc = beta * vc + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
                u = g / torch.sqrt(denom + eps)
            else:
                vf = beta * vf + (1 - beta) * g2
                u = g / torch.sqrt(vf + eps)
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return -learning_rate * u, vr, vc, vf

        outs = tree_map(upd, grads, state.v_row, state.v_col, state.v_full)
        return _pick(outs, 0), AdafactorState(count, _pick(outs, 1),
                                              _pick(outs, 2), _pick(outs, 3))

    return GradientTransformation(init, update)


def _pick(tree, i):
    """Element ``i`` of the tuples at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def warmup_cosine(peak_lr, warmup_steps, total_steps, end_lr_frac=0.1):
    """The learning rate at a host step count, computed in float32 as the
    JAX package computes it on the card."""
    def schedule(step):
        step = _F32(step)
        warm = _F32(peak_lr) * step / _F32(max(warmup_steps, 1))
        prog = np.clip((step - _F32(warmup_steps))
                       / _F32(max(total_steps - warmup_steps, 1)),
                       _F32(0), _F32(1))
        cos = _F32(peak_lr) * (_F32(end_lr_frac) + _F32(1 - end_lr_frac)
                               * _F32(0.5) * (_F32(1) + np.cos(
                                   _F32(math.pi) * prog)))
        return warm if step < warmup_steps else cos

    return schedule
