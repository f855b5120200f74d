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
- :func:`infer_discrete` recovers the posterior of the marginalized sites
  given continuous draws: forward-filter/backward-sample for ``markov``
  chains (one ``enum_chain`` launch for the filter, one
  ``enum_chain_sample`` launch for the draws on a card), exact sequential
  conditioning on the joint enumeration tensor for parallel sites.

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
- The sample mode's ``rng_key`` is a draw source (``fresh()``, ``gumbel(shape,
  dtype)``, ``.generator``; :class:`~repro_torch.core.infer.hmc_util.
  GeneratorDraws`), its noise drawn on the CPU and moved to the factors'
  device; a categorical draw is ``argmax(gumbel + logits)``, which is what
  ``jax.random.categorical`` computes, so a test that injects the JAX
  package's noise gets its draws index for index.  The draws are int64
  (the JAX package's are int32).
"""
from __future__ import annotations

import math
import warnings
from collections import OrderedDict
from typing import Optional

import torch

from ...kernels import ops
from .. import dist as _dist
from .. import primitives
from ..errors import ReproNotImplementedError, ReproValueError
from ..handlers import (Messenger, _as_generator, block, infer_config,
                        scope, seed, trace)
from ..primitives import deterministic as _deterministic
from ..primitives import plate as _plate
from ..primitives import sample as _sample
from .hmc_util import GeneratorDraws, to_device
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

    ``mode="sample"`` (used by :func:`infer_discrete`) also carries a draw
    source ``draws`` (the JAX package's ``rng_key``: an object with
    ``fresh()`` and ``gumbel(shape, dtype)``, such as
    :class:`~repro_torch.core.infer.hmc_util.GeneratorDraws`);
    :func:`markov` then backward-samples its chain into ``.samples``
    instead of emitting a marginal factor.
    """

    def __init__(self, fn=None, first_available_dim=None, *,
                 mode: str = "marginal", draws=None, strict: bool = False,
                 extra_dims: Optional[dict] = None):
        super().__init__(fn)
        if first_available_dim is None or first_available_dim >= 0:
            raise ValueError(
                "enum requires a negative first_available_dim — use "
                "-(max_plate_nesting + 1), counting every plate/batch dim "
                f"of the model; got {first_available_dim}")
        if mode not in ("marginal", "sample"):
            raise ValueError(f"unknown enum mode {mode!r}")
        if mode == "sample" and draws is None:
            raise ValueError("enum(mode='sample') requires a draw source "
                             "(draws=GeneratorDraws(generator))")
        self.first_available_dim = int(first_available_dim)
        self.mode = mode
        self.draws = draws
        self.strict = strict          # markov-internal: no stray latents
        self._markov_local = False    # set on markov's per-step instances
        # enumeration dims owned by an enclosing allocator (markov hands its
        # local per-step handler the chain's `prev` dim this way) — batch
        # extents at these dims are legitimate, not collisions
        self._extra_dims = dict(extra_dims or {})
        self.samples: dict = {}
        self._next = self.first_available_dim
        self._alloc: OrderedDict = OrderedDict()

    def __enter__(self):
        self._next = self.first_available_dim
        self._alloc = OrderedDict()
        self.samples = {}
        return super().__enter__()

    def allocate(self, size: int, name: str) -> int:
        dim = self._next
        self._next -= 1
        self._alloc[name] = (dim, int(size))
        return dim

    def fresh_key(self):
        """A fresh draw source split from the handler's (``fresh_key`` of
        the JAX package)."""
        return self.draws.fresh()

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
      must not be consumed downstream under marginalization;
    - ``enum(mode="sample")`` (:func:`infer_discrete`): the same factors,
      then forward-filter/backward-sample: every alpha from one call of
      :func:`repro_torch.kernels.ops.enum_chain_alphas`, one draw of
      Gumbel noise ``(T, K)`` from a fresh source of the handler (row t is
      state t's), and the states from last to first in one call of
      :func:`repro_torch.kernels.ops.enum_chain_sample`.  The states are
      recorded as the deterministic site ``name`` and in the handler's
      ``samples``, and returned; no marginal factor is emitted.
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

    if handler.mode == "marginal":
        alpha_T = ops.enum_chain(alpha0, mats)
        total = torch.logsumexp(alpha_T, dim=-1)
        _sample(f"{name}_marginal",
                _dist.Delta(total.new_zeros(()), log_density=total),
                obs=total.new_zeros(()))
        return None

    # --- mode == "sample": forward filter, backward sample -----------------
    alphas = ops.enum_chain_alphas(alpha0, mats)                 # (T, K)
    noise = handler.fresh_key().gumbel(tuple(alphas.shape), alphas.dtype)
    idx = ops.enum_chain_sample(alphas, mats.detach().to(alphas.dtype),
                                to_device(noise, alphas.device))
    states = support_flat[idx]
    _deterministic(name, states)
    handler.samples[name] = states
    return states


# ---------------------------------------------------------------------------
# infer_discrete: posterior of the marginalized sites
# ---------------------------------------------------------------------------

def _condition_factor(f, d: int, idx):
    """Index factor ``f`` at enumeration dim ``d`` by ``idx`` (the sampled
    per-plate-element state indices, right-aligned to the plate region)."""
    axis = f.dim() + d
    want = f.dim() - 1
    ie = idx.reshape((1,) * max(0, want - idx.dim())
                     + tuple(idx.shape)[max(0, idx.dim() - want):])
    ie = ie.unsqueeze(axis)
    ie = ie.expand(tuple(f.shape[:axis]) + (1,) + tuple(f.shape[axis + 1:]))
    return torch.gather(f, axis, ie)


def _sample_parallel_sites(tr, handler: enum, draws):
    """Exact sequential sampling of the parallel-enumerated sites: for each
    site (in allocation order), eliminate every other pending enumeration
    dim from a working copy of the factor pool, reduce foreign plates, and
    draw from the resulting per-plate-element conditional (one Gumbel draw
    of its logits' shape from ``draws``); then condition the pool on the
    draw (chain rule: the exact joint posterior)."""
    sites = [(nm, dim, size) for nm, (dim, size) in handler._alloc.items()
             if nm in tr and tr[nm]["infer"].get("_enumerate_dim") == dim]
    if not sites:
        return {}

    alloc, factors, _ = _collect_enum_factors(tr)
    pending_dims = {dim for _, dim, _ in sites}
    out = {}
    for nm, dim, size in sites:
        work, _ = _eliminate(factors, alloc, pending_dims - {dim})
        boundary = max(alloc)
        f = None
        for g, gds in work:
            if dim not in gds:
                continue  # constant in this site: normalization only
            g = _reduce_foreign_plates(g, {dim}, dim, alloc, boundary)
            f = g if f is None else f + g
        logits = torch.movedim(f, f.dim() + dim, -1).detach()
        noise = draws.gumbel(tuple(logits.shape), logits.dtype)
        idx = torch.argmax(to_device(noise, logits.device) + logits, dim=-1)
        factors = [(_condition_factor(g, dim, idx) if dim in gds else g,
                    gds - {dim}) for g, gds in factors]
        pending_dims.discard(dim)
        # the recorded draw has the site's plate-region shape: batch extents
        # in the enumeration region come from upstream enumerated values
        # (parameters indexed by another enumerated site) and are not part
        # of a single draw
        width = -max(alloc) - 1
        site_batch = tuple(tr[nm]["fn"].batch_shape)
        target = site_batch[len(site_batch) - width:] if width else ()
        while target and target[0] == 1:
            target = target[1:]
        support_flat = tr[nm]["fn"].enumerate_support(
            expand=False).reshape(-1).to(idx.device)
        out[nm] = support_flat[idx].reshape(target)
    return out


def _as_draws(generator):
    """A draw source of ``infer_discrete``'s draws: a draw source as it is,
    or a new :class:`GeneratorDraws` from a copy of a ``torch.Generator``'s
    state (or a new one seeded with an int), so that every call of ``run``
    draws the same."""
    if hasattr(generator, "fresh"):
        return lambda: generator
    state = _as_generator(generator).get_state()
    return lambda: GeneratorDraws(torch.Generator().set_state(state))


def infer_discrete(model, generator, *, max_plate_nesting=None,
                   device=None):
    """Sample the marginalized discrete latents from their exact posterior.

    Given a model whose continuous latents are pinned (compose with
    ``substitute(model, data=continuous_draw)``), returns a callable
    ``run(*model_args, **model_kwargs) -> {site: integer draws}``:
    parallel-enumerated sites are sampled by exact conditioning on the joint
    enumeration tensor, :func:`markov` chains by forward-filter /
    backward-sample.  Stray unpinned latent sites are seeded from
    ``generator`` (prior draws), as ``Predictive`` does.  The model runs on
    ``device`` (default ``"cuda"``; ``resolve_device`` raises without a
    card), its arguments moved there as ``MCMC.run`` moves them.

    ``generator`` is a CPU ``torch.Generator`` (its state is copied here,
    so every call of ``run`` draws the same, as the JAX package's ``run``
    is a function of its key), an int seed, or a draw source (``fresh()``,
    ``gumbel(shape, dtype)``, ``.generator``; a test injects the JAX
    package's noise through one).  The draws, in order:

    1. ``source.fresh()`` -> ``k_seed``, then ``source.fresh()`` ->
       ``k_disc`` (the JAX package's ``split(rng_key)``);
    2. ``k_seed.generator``'s state seeds the stray latents of the probe
       trace and, from the same state again, of the sampling trace;
    3. each :func:`markov` chain, in program order: ``k_disc.fresh()`` ->
       ``src``, then ``src.gumbel((T, K))``, row t the noise of state t
       (the JAX package: ``split(fresh_key())`` -> ``key_last`` for state
       T-1, ``split(key_rest, T-1)[t]`` for state t);
    4. the parallel sites: ``k_disc.fresh()`` -> ``src``, then for each
       site in allocation order ``src.gumbel(logits.shape)`` (the JAX
       package: one ``split`` of that key per site).

    The JAX package vectorizes over posterior draws with ``jax.vmap`` over
    ``(draw, key)`` pairs; here that is a Python loop of calls, one
    generator each, as :class:`~repro_torch.core.infer.util.Predictive`
    loops over its draws.
    """
    if generator is None:
        raise ValueError("infer_discrete requires a torch.Generator, an int "
                         "seed or a draw source")
    from .hmc import resolve_device
    from .mcmc import _to_device
    device = resolve_device(device if device is not None else "cuda")
    new_source = _as_draws(generator)

    def run(*args, **kwargs):
        args, kwargs = _to_device(args, device), _to_device(kwargs, device)
        source = new_source()
        k_seed, k_disc = source.fresh(), source.fresh()
        seed_state = k_seed.generator.get_state()
        # auto-mark enumerable discrete latents, as
        # initialize_model_structure does: untouched model code just works
        marked = config_enumerate(model)

        def seeded():
            return seed(marked, torch.Generator().set_state(seed_state))

        probe = _EnumProbe(seeded())
        trace(probe).get_trace(*args, **kwargs)
        if not probe.found:
            warnings.warn(
                "infer_discrete: the model has no enumerated sites (mark "
                "discrete latents with infer={'enumerate': 'parallel'} or "
                "wrap the model in config_enumerate)", stacklevel=2)
            return {}
        fad = _first_available_dim(probe, max_plate_nesting)
        handler = enum(seeded(), first_available_dim=fad, mode="sample",
                       draws=k_disc)
        with torch.no_grad(), handler:
            tr = trace(handler.fn).get_trace(*args, **kwargs)
        samples = dict(handler.samples)
        with torch.no_grad():
            samples.update(_sample_parallel_sites(tr, handler,
                                                  handler.fresh_key()))
        return samples

    return run


__all__ = [
    "config_enumerate",
    "contract_enum_factors",
    "enum",
    "infer_discrete",
    "markov",
]
