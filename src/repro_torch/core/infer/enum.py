"""Discrete-latent enumeration: exact marginalization by effect handlers.

NUTS only moves continuous latents; what makes the modeling language general
is summing discrete latents out exactly, implemented purely with handlers
and broadcasting (the JAX package's ``repro.core.infer.enum``, ported):

- The :class:`enum` handler substitutes, for every latent sample site marked
  ``infer={"enumerate": "parallel"}``, the distribution's full support
  broadcast into a fresh leftmost batch dim from a plate-aware allocator
  (enumeration dims live at ``dim <= first_available_dim``, strictly to the
  left of every plate/batch dim, so they never collide).
- :func:`contract_enum_factors` is the enum-aware density contraction of
  :func:`repro_torch.core.infer.util.log_density`: per-site ``mask`` (then
  ``scale``) apply as usual, after which the enumeration dims are summed out
  by variable elimination in log space.
- :func:`markov` is the sequential counterpart for chain-structured models:
  it eliminates the state along the time axis at O(T·K²), the T-1 logsumexp
  contractions in one call of :func:`repro_torch.kernels.ops.enum_chain`
  (the hand-written chain kernels on a card, one launch forward and one
  backward; the plain chain on the CPU).

Differences from the JAX package, by design:

- ``jax.vmap(step_factor)`` becomes ``torch.func.vmap`` over the same
  function: the handlers run once, on tensors with a hidden time dim.
- ``lax.scan`` of ``ops.enum_contract`` becomes one ``ops.enum_chain``
  call: one autograd node, one forward and one backward kernel launch per
  gradient, where a loop of one-step calls would make T-1 of each.
- Observed values inside the vectorized transition are not support-checked
  (the JAX package skips them as tracers); nor is step 0 inside a potential
  that marks its sites checked (``util._SupportChecked``): the plain
  simulation at setup checked every step once.

``infer_discrete``, ``markov``'s ``"sample"`` mode (forward-filter /
backward-sample), parallel-site sampling and ``RequirePinnedDiscrete`` wait
for a later slice (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import torch

from ...kernels import ops
from .. import dist as _dist
from .. import primitives
from ..errors import ReproNotImplementedError, ReproValueError, pending
from ..handlers import Messenger, block, infer_config, scope, trace
from ..primitives import plate as _plate
from ..primitives import sample as _sample
from .util import _SupportChecked

_NOT_ENUMERABLE_ERR = (
    "cannot enumerate site '{name}': {fn} has no enumerate_support (only "
    "finite-support discrete distributions can be enumerated — a continuous "
    "site cannot). Remove infer={{'enumerate': 'parallel'}} from the site, "
    "or observe/substitute it.")


def _ndim(value) -> int:
    return value.dim() if isinstance(value, torch.Tensor) else 0


def _is_enumerable_latent(msg: dict) -> bool:
    return (msg["type"] == "sample" and not msg["is_observed"]
            and msg["value"] is None
            and getattr(msg["fn"], "has_enumerate_support", False))


def _auto_parallel(msg: dict) -> bool:
    """Unmarked enumerable latent with no generator in reach: nothing but
    enumeration can value it, so ``log_density`` auto-detects it.  Seeded
    traces keep their draw semantics — the mark stays opt-in there."""
    return (_is_enumerable_latent(msg)
            and msg["infer"].get("enumerate") is None
            and msg["kwargs"].get("generator") is None)


def config_enumerate(fn=None):
    """Mark every enumerable discrete latent site for parallel enumeration.

    Thin :class:`~repro_torch.core.handlers.infer_config` wrapper setting
    ``infer={"enumerate": "parallel"}`` on latent sample sites whose
    distribution ``has_enumerate_support`` (sites that already carry an
    ``enumerate`` entry are left alone).  The mark is inert outside density
    evaluation: a seeded simulation still draws the site normally.
    """
    def _cfg(msg):
        if _is_enumerable_latent(msg) and "enumerate" not in msg["infer"]:
            return {"enumerate": "parallel"}
        return {}

    return infer_config(fn, config_fn=_cfg)


class _EnumProbe(Messenger):
    """Pass-1 detector for the enum-aware ``log_density``.

    Inert for models without enumeration: it only measures the deepest
    plate/batch dim of any sample site (the plate-aware allocator's budget)
    and whether any site requests enumeration.  Marked sites get a cheap
    probe value (the lowest support element, broadcast-ready) so the trace
    completes without a generator; the probe trace is discarded whenever
    enumeration is detected and a real :class:`enum` pass follows.
    """

    def __enter__(self):
        self.found = False
        self.max_plate_nesting = 0
        self.min_marked_dim = 0  # most negative dim pre-allocated by an
        #                          inner (user-managed) enum handler
        return super().__enter__()

    def process_message(self, msg: dict) -> None:
        if msg["type"] != "sample":
            return
        fn = msg["fn"]
        nd = len(getattr(fn, "batch_shape", ()))
        for frame in msg["cond_indep_stack"]:
            nd = max(nd, -frame.dim)
        if msg["value"] is not None:
            nd = max(nd, _ndim(msg["value"]) - getattr(fn, "event_dim", 0))
        self.max_plate_nesting = max(self.max_plate_nesting, nd)
        d = msg["infer"].get("_enumerate_dim")
        if d is not None:  # an inner enum handler already enumerated it
            self.found = True
            self.min_marked_dim = min(self.min_marked_dim, d)
            return
        if _auto_parallel(msg):
            msg["infer"]["enumerate"] = "parallel"
        if (msg["infer"].get("enumerate") == "parallel"
                and not msg["is_observed"] and msg["value"] is None):
            self.found = True
            if not getattr(fn, "has_enumerate_support", False):
                raise ReproValueError(_NOT_ENUMERABLE_ERR.format(
                    name=msg["name"], fn=type(fn).__name__),
                    code="RPL013", site=msg["name"])
            msg["value"] = fn.enumerate_support(expand=False)[0]
            msg["infer"]["_enum_probe"] = True


def _first_available_dim(probe: _EnumProbe, max_plate_nesting=None) -> int:
    mpn = (probe.max_plate_nesting if max_plate_nesting is None
           else max_plate_nesting)
    return min(-int(mpn) - 1, probe.min_marked_dim - 1)


class enum(Messenger):
    """Parallel-enumeration handler.

    Effect: ``process_message`` — for latent sample sites marked
    ``infer={"enumerate": "parallel"}``, replaces the would-be draw with the
    distribution's full support stacked into a fresh leftmost dim allocated
    from ``first_available_dim`` downwards (``first_available_dim`` must be
    ``-(max_plate_nesting + 1)`` or deeper).  The allocated dim and support
    size are recorded in ``msg["infer"]["_enumerate_dim"] /
    ["_enum_total"]`` — the breadcrumbs :func:`contract_enum_factors`
    eliminates by.

    Only ``mode="marginal"`` is ported; ``mode="sample"`` (what
    ``infer_discrete`` uses) raises ``RPL501``.
    """

    def __init__(self, fn=None, first_available_dim=None, *,
                 mode: str = "marginal", strict: bool = False,
                 extra_dims: Optional[dict] = None):
        super().__init__(fn)
        if first_available_dim is None or first_available_dim >= 0:
            raise ValueError(
                "enum requires a negative first_available_dim — use "
                "-(max_plate_nesting + 1), counting every plate/batch dim "
                f"of the model; got {first_available_dim}")
        if mode == "sample":
            raise pending("enum(mode='sample') (infer_discrete)",
                          "discrete posterior sampling")
        if mode != "marginal":
            raise ValueError(f"unknown enum mode {mode!r}")
        self.first_available_dim = int(first_available_dim)
        self.mode = mode
        self.strict = strict          # markov-internal: no stray latents
        self._markov_local = False    # set on markov's per-step instances
        # enumeration dims owned by an enclosing allocator (markov hands its
        # local per-step handler the chain's `prev` dim this way) — batch
        # extents at these dims are legitimate, not collisions
        self._extra_dims = dict(extra_dims or {})
        self._next = self.first_available_dim
        self._alloc: OrderedDict = OrderedDict()

    def __enter__(self):
        self._next = self.first_available_dim
        self._alloc = OrderedDict()
        return super().__enter__()

    def allocate(self, size: int, name: str) -> int:
        dim = self._next
        self._next -= 1
        self._alloc[name] = (dim, int(size))
        return dim

    def process_message(self, msg: dict) -> None:
        if msg["type"] != "sample":
            return
        if msg["value"] is not None or msg["is_observed"]:
            return
        strategy = msg["infer"].get("enumerate")
        if strategy is None and _auto_parallel(msg):
            strategy = "parallel"
        if strategy is None:
            if self.strict and not getattr(msg["fn"], "has_enumerate_support",
                                           False):
                raise RuntimeError(
                    f"latent site '{msg['name']}' inside a markov transition "
                    "is neither observed nor enumerable; sample continuous "
                    "latents outside the transition function")
            return
        if strategy != "parallel":
            raise ValueError(
                f"unknown enumerate strategy {strategy!r} for site "
                f"'{msg['name']}' (only 'parallel' is supported)")
        fn = msg["fn"]
        if not getattr(fn, "has_enumerate_support", False):
            raise ReproValueError(_NOT_ENUMERABLE_ERR.format(
                name=msg["name"], fn=type(fn).__name__),
                code="RPL013", site=msg["name"])
        if tuple(msg["kwargs"].get("sample_shape") or ()) != ():
            raise NotImplementedError(
                f"site '{msg['name']}': sample_shape does not compose with "
                "enumeration; use a plate instead")
        for frame in msg["cond_indep_stack"]:
            if frame.dim <= self.first_available_dim:
                raise ReproValueError(
                    f"plate '{frame.name}' occupies dim {frame.dim}, which "
                    f"collides with the enumeration dims (first_available_dim"
                    f"={self.first_available_dim}); pass a deeper "
                    "first_available_dim / max_plate_nesting",
                    code="RPL003", site=frame.name)
        # batch dims reaching into the enumeration region are fine exactly
        # when they *are* enumeration dims (the site's parameters depend on
        # another enumerated value); anything else is a plate-budget bug
        known = dict(self._extra_dims)
        known.update({dim: size for dim, size in self._alloc.values()})
        batch_shape = tuple(fn.batch_shape)
        for d in range(-len(batch_shape), self.first_available_dim + 1):
            if batch_shape[d] != 1 and known.get(d) != batch_shape[d]:
                raise ReproValueError(
                    f"site '{msg['name']}' has batch extent {batch_shape[d]} "
                    f"at dim {d}, inside the enumeration region "
                    f"(first_available_dim={self.first_available_dim}) but "
                    "matching no enumerated site — deepen "
                    "first_available_dim / max_plate_nesting",
                    code="RPL003", site=msg["name"])
        support = fn.enumerate_support(expand=False)
        size = support.shape[0]
        dim = self.allocate(size, msg["name"])
        msg["value"] = support.reshape((size,) + (1,) * (-dim - 1))
        msg["infer"]["_enumerate_dim"] = dim
        msg["infer"]["_enum_total"] = size


def _site_log_prob(site: dict):
    """Per-site log factor with the message-protocol contract applied:
    mask zeroes elements before the multiplicative scale.

    For an *enumerated* site, a masked-out element's factor is the
    normalized uniform ``-log K`` rather than 0: the later ``logsumexp``
    over its K enumerated values then contributes exactly 0 — the site
    drops out of the density, matching the non-enumerated mask contract."""
    lp = site["fn"].log_prob(site["value"])
    if site["mask"] is not None:
        d = site["infer"].get("_enumerate_dim")
        fill = -math.log(float(site["infer"]["_enum_total"])) \
            if d is not None else 0.0
        lp = torch.where(site["mask"], lp, torch.full_like(lp, fill))
    if site["scale"] is not None:
        lp = lp * site["scale"]
    return lp


def _owns_plate(site_batch, p: int) -> bool:
    """Does the enumerated site with (plate-expanded) batch shape
    ``site_batch`` range over plate dim ``p``?"""
    return len(site_batch) >= -p and site_batch[p] != 1


def _reduce_foreign_plates(f, ds, d: int, alloc, boundary: int):
    """Sum out of factor ``f`` every plate dim that the enumerated variable
    ``d`` does *not* range over (and that no other enumeration dim still
    pending in ``ds`` owns) — log factors multiply independently across such
    plates, so they reduce by a plain sum *before* the logsumexp over ``d``.
    A plate dim ``d`` ranges over but ``f`` is constant across means the
    enumerated value escaped its plate: that joint is not representable with
    one enumeration dim, so fail loudly."""
    _, site_batch = alloc[d]
    sum_axes = []
    for p in range(boundary + 1, 0):
        if f.dim() < -p:
            continue
        if _owns_plate(site_batch, p):
            if f.shape[p] == 1:
                raise NotImplementedError(
                    f"enumerated site at dim {d} is used outside its plate "
                    f"(a factor is constant across plate dim {p}); move the "
                    "dependent site inside the plate")
            continue
        if f.shape[p] != 1 and not any(
                d2 != d and _owns_plate(alloc[d2][1], p) for d2 in ds):
            sum_axes.append(p)
    if sum_axes:
        f = torch.sum(f, dim=tuple(sum_axes), keepdim=True)
    return f


def _eliminate(factors, alloc, dims):
    """Variable elimination of ``dims`` (most-negative first) over the factor
    pool.  Returns ``(remaining_factors, const)`` where ``const`` accumulates
    the fully-contracted scalars.  Because elimination proceeds leftmost-dim
    first, removing an axis never shifts the (right-counted) positions of the
    dims still pending."""
    const = 0.0
    factors = list(factors)
    for d in sorted(dims):
        group = [fd for fd in factors if d in fd[1]]
        if not group:
            continue
        factors = [fd for fd in factors if d not in fd[1]]
        boundary = max(alloc)
        f, ds = None, set()
        for g, gds in group:
            g = _reduce_foreign_plates(g, gds, d, alloc, boundary)
            f = g if f is None else f + g
            ds |= gds
        f = torch.logsumexp(f, dim=d)
        ds.discard(d)
        if ds:
            factors.append((f, frozenset(ds)))
        else:
            const = const + torch.sum(f)
    return factors, const


def _collect_enum_factors(tr):
    """Split a trace's sample sites into (alloc, enum factors, plain
    log-density sum).  ``alloc`` maps each enumeration dim to ``(support
    size, site batch shape)`` — the batch shape (plate-expanded) is what
    tells elimination which plate dims the enumerated variable ranges over.
    """
    alloc = {}
    for site in tr.values():
        if site["type"] != "sample":
            continue
        d = site["infer"].get("_enumerate_dim")
        if d is not None:
            alloc[d] = (site["infer"]["_enum_total"],
                        tuple(site["fn"].batch_shape))

    log_plain = 0.0
    factors = []
    for site in tr.values():
        if site["type"] != "sample":
            continue
        lp = _site_log_prob(site)
        dims = set()
        for d, (size, _) in alloc.items():
            if lp.dim() >= -d and lp.shape[d] != 1:
                if lp.shape[d] != size:
                    raise ValueError(
                        f"site '{site['name']}': log factor extent "
                        f"{lp.shape[d]} at enumeration dim {d} does not "
                        f"match the enumerated support size {size}")
                dims.add(d)
        if dims:
            factors.append((lp, frozenset(dims)))
        else:
            log_plain = log_plain + torch.sum(lp)
    return alloc, factors, log_plain


def contract_enum_factors(tr):
    """Sum out every enumeration dim of a traced model by variable
    elimination, returning the scalar joint log density.

    Sites whose log factor mentions no enumeration dim accumulate directly
    (plate dims are independent products — a plain sum, as in the non-enum
    path).  Factors that do are eliminated one dim at a time, most-negative
    (latest-allocated, i.e. deepest in the program) first: each factor first
    sums out the plate dims the variable does not range over, then the group
    is broadcast-added and ``logsumexp``-contracted over the dim, and the
    resulting message re-enters the factor pool.
    """
    alloc, factors, log_joint = _collect_enum_factors(tr)
    leftover, const = _eliminate(factors, alloc, set(alloc))
    if leftover:
        raise RuntimeError("enumeration factors left after elimination")
    return log_joint + const


# ---------------------------------------------------------------------------
# markov: sequential elimination along a chain
# ---------------------------------------------------------------------------

class RequirePinnedDiscrete(Messenger):
    """Guard for utilities that score models without enumerating
    (``log_likelihood``): an enumerable discrete latent that nothing pinned
    and no generator reaches would fail mid-trace, so raise a diagnosis
    instead."""

    def __init__(self, fn=None, what: str = "this utility"):
        super().__init__(fn)
        self.what = what

    def process_message(self, msg: dict) -> None:
        if _is_enumerable_latent(msg) \
                and msg["kwargs"].get("generator") is None:
            raise NotImplementedError(
                f"{self.what}: discrete latent site '{msg['name']}' is "
                "marginalized by inference and absent from the posterior "
                "samples; pin it by including infer_discrete draws in "
                "posterior_samples")


class _RequireEnumerable(Messenger):
    """Guard for markov transition bodies: any latent site that cannot be
    enumerated has no business inside the per-step factor computation."""

    def process_message(self, msg: dict) -> None:
        if (msg["type"] == "sample" and not msg["is_observed"]
                and msg["value"] is None
                and not getattr(msg["fn"], "has_enumerate_support", False)):
            raise RuntimeError(
                f"latent site '{msg['name']}' inside a markov transition "
                "is neither observed nor enumerable; sample continuous "
                "latents outside the transition function")


def _find_enum_state():
    """Innermost enum-machinery handler on the stack (enum beats probe)."""
    for handler in reversed(primitives.stack()):
        if isinstance(handler, (enum, _EnumProbe)):
            return handler
    return None


def _assert_no_active_plates(what: str) -> None:
    for handler in primitives.stack():
        if isinstance(handler, _plate) and handler._frame is not None:
            raise ReproNotImplementedError(
                f"{what} inside an active plate is not supported; vmap the "
                "whole model over the batch of sequences instead",
                code="RPL014", site=handler.name)


def _step_factor(tr, plate_budget: int, dims):
    """Collapse one markov step's local trace into a factor over ``dims``
    (ascending, i.e. prev before cur).

    Within-step plate dims (the rightmost ``plate_budget`` axes) are summed —
    conditionally independent given the state — so the factor's only axes are
    the chain's enumeration dims; any other enumeration dim leaking in (a
    transition depending on a separately enumerated site) is a loud error.
    """
    nd = -min(dims) - plate_budget
    acc = None
    for site in tr.values():
        if site["type"] != "sample":
            continue
        lp = _site_log_prob(site)
        if lp.dim() > plate_budget:
            if plate_budget:
                lp = torch.sum(lp, dim=tuple(range(-plate_budget, 0)))
        else:
            lp = torch.sum(lp)
        lp = lp.reshape((1,) * (nd - lp.dim()) + tuple(lp.shape))
        for ax in range(nd):
            orig_dim = (ax - nd) - plate_budget
            if lp.shape[ax] != 1 and orig_dim not in dims:
                raise NotImplementedError(
                    f"markov: the factor of site '{site['name']}' depends on "
                    f"enumeration dim {orig_dim} outside the chain; markov "
                    "transitions may only depend on the previous state")
        acc = lp if acc is None else acc + lp
    shape = tuple(acc.shape[nd + d + plate_budget] for d in dims)
    return acc.reshape(shape)


def _tree_map(fn, tree):
    """``fn`` over the tensors of a (tuple/list/dict-nested) ``xs``."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in trees])


def _step0_checker() -> Messenger:
    """The handler around markov's step 0: ``_SupportChecked`` when the
    enclosing density already marks its sites checked (the potential),
    else an inert one."""
    if any(isinstance(h, _SupportChecked) for h in primitives.stack()):
        return _SupportChecked()
    return Messenger()


def markov(fn, init, xs, *, name: str = "markov"):
    """Chain-structured sequential enumeration combinator.

    ``fn(carry, x) -> carry`` is one transition: it must contain exactly one
    enumerable latent sample site (the state, whose value it returns as the
    new carry); every other site inside must be observed.  ``xs`` is a
    tensor, or a tuple/list/dict of tensors, with a leading time axis of
    length T.

    Semantics depend on context:

    - plain simulation (``seed``/``trace``, no enumeration active): runs the
      transition T times under per-step
      :class:`~repro_torch.core.handlers.scope` prefixes (``{name}/{t}/...``)
      and returns the stacked carries ``(T, ...)``;
    - enum-aware ``log_density``: computes per-step factors ``log p(z_t |
      z_{t-1}) + log p(obs_t | z_t)`` for all steps at once (one
      ``torch.func.vmap`` over time), eliminates the state along the time
      axis with one call of :func:`repro_torch.kernels.ops.enum_chain` (the
      T-1 contractions), and contributes the chain's marginal likelihood as
      a single ``{name}_marginal`` factor site.  Returns ``None``: the carry
      must not be consumed downstream under marginalization.
    """
    leaves = _tree_leaves(xs)
    if not leaves:
        raise ValueError("markov requires xs with at least one tensor leaf")
    T = leaves[0].shape[0]
    if T == 0:
        raise ValueError("markov requires a non-empty time axis")

    handler = _find_enum_state()

    if handler is None:  # plain simulation
        carries = []
        carry = init
        for t in range(T):
            x_t = _tree_map(lambda a: a[t], xs)
            with scope(prefix=f"{name}/{t}"):
                carry = fn(carry, x_t)
            carries.append(carry)
        return _tree_stack(carries)

    if getattr(handler, "_markov_local", False):
        raise NotImplementedError("nested markov is not supported")
    _assert_no_active_plates("markov")
    x0 = _tree_map(lambda a: a[0], xs)

    if isinstance(handler, _EnumProbe):
        # measurement pass: run one step so within-step plates and the state
        # site are counted, then hand back a carry of the right structure
        handler.found = True
        with scope(prefix=f"{name}/probe"), config_enumerate(), \
                _RequireEnumerable():
            carry = fn(init, x0)
        return _tree_map(
            lambda v: torch.as_tensor(v).broadcast_to(
                (T,) + tuple(torch.as_tensor(v).shape)), carry)

    plate_budget = -handler.first_available_dim - 1

    # --- step 0: discover the state site and its support ------------------
    e0 = enum(first_available_dim=handler._next, strict=True)
    e0._markov_local = True
    with block(), trace() as tr0, e0, config_enumerate(), _step0_checker():
        fn(init, x0)
    if len(e0._alloc) != 1:
        raise ValueError(
            f"markov '{name}': the transition must contain exactly one "
            f"enumerable latent state site, found {list(e0._alloc) or 'none'}")
    state_name, (d0, K) = next(iter(e0._alloc.items()))
    d_cur = handler.allocate(K, f"_markov/{name}/cur")
    if d_cur != d0:
        raise RuntimeError(f"markov '{name}': the state's dim {d0} is not "
                           f"the chain's {d_cur}")
    d_prev = handler.allocate(K, f"_markov/{name}/prev")
    support = tr0[state_name]["fn"].enumerate_support(expand=False)
    support_flat = support.reshape(-1)
    alpha0 = _step_factor(tr0, plate_budget, (d_cur,))          # (K,)

    # --- steps 1..T-1: transition factors, vectorized over time -----------
    if T > 1:
        prev_value = support_flat.reshape((K,) + (1,) * (-d_prev - 1))
        e1 = enum(first_available_dim=d_cur, strict=True,
                  extra_dims={d_prev: K})
        e1._markov_local = True

        def step_factor(x_t):
            # under vmap: observed values are never support-checked here
            with block(), trace() as tr, e1, config_enumerate(), \
                    _SupportChecked():
                fn(prev_value, x_t)
            (nm, (d, k)), = e1._alloc.items()
            if (d, k) != (d_cur, K) or nm != state_name:
                raise ValueError(
                    f"markov '{name}': transition structure changed between "
                    f"steps (state site '{state_name}' with {K} states "
                    f"became '{nm}' with {k})")
            return _step_factor(tr, plate_budget, (d_prev, d_cur))

        xs_rest = _tree_map(lambda a: a[1:], xs)
        mats = torch.func.vmap(step_factor)(xs_rest)            # (T-1, K, K)
    else:
        mats = alpha0.new_zeros((0, K, K))

    alpha_T = ops.enum_chain(alpha0, mats)
    total = torch.logsumexp(alpha_T, dim=-1)
    _sample(f"{name}_marginal",
            _dist.Delta(total.new_zeros(()), log_density=total),
            obs=total.new_zeros(()))
    return None


def infer_discrete(model, generator=None, *, max_plate_nesting=None):
    """Sampling the marginalized discrete latents from their posterior
    (forward-filter/backward-sample) waits for a later slice."""
    raise pending("infer_discrete", "discrete posterior sampling")


__all__ = [
    "config_enumerate",
    "contract_enum_factors",
    "enum",
    "infer_discrete",
    "markov",
]
