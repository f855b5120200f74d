"""Static analysis for models and functions (``RPL###`` rules), the JAX
package's ``repro.core.lint`` in PyTorch.

Three layers, one code vocabulary (:mod:`repro_torch.lint_rules` for the
rule registry, :mod:`repro_torch.core.errors` for the runtime twins):

1. :func:`lint_model`: the model linter.  The model is traced *once* with
   the inert probe the enum-aware ``log_density`` uses, and every coded
   runtime error or warning raised during that trace becomes a finding with
   the code the runtime would raise, so lint/runtime parity for the whole
   error family is structural.  Post-trace rules cover what the runtime
   tolerates: float64 data in a float32 model (RPL010), handler keys that
   matched no site (RPL006) and seed handlers baked into the model
   (RPL015).  Tensors on the ``meta`` device stand in for the JAX
   package's ``ShapeDtypeStruct``: the trace then runs abstractly, with no
   arithmetic on the data, and value rules such as the observed-support
   check (RPL005) skip meta values.
2. :func:`analyze`: hazards in the aten ops that one execution of a
   function dispatches (a ``TorchDispatchMode`` records them, where the JAX
   package reads a jaxpr): large tensors the function closes over
   (RPL101), device->host reads (RPL102) and narrowing float conversions
   (RPL103).  :func:`count_eqns` counts the recorded ops, a registered
   kernel op (``ops.OP_TABLE``, ``FUSED``, ``BACKWARD``) as one node
   whichever route it took, and :func:`check_time_independence` (RPL104)
   holds a ``markov`` program's count equal at two lengths of the time
   axis.
3. The op-registry and ``KernelSetup`` invariants (RPL201-204) live in
   :mod:`repro_torch.lint_rules.invariants`.

CLI: ``python -m repro_torch.lint <module:model>``
(:mod:`repro_torch.lint`).  ``MCMC(..., validate=True)`` /
``SVI(..., validate=True)`` run :func:`lint_model` once per fresh setup
and raise on errors.
"""
from __future__ import annotations

import sys
import warnings
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..lint_rules import ERROR, RULES, WARN
from .errors import ReproError, ReproValueError, warning_code
from .handlers import Messenger, condition, do, seed, substitute, trace


class Finding(NamedTuple):
    """One lint result: a rule code, its severity, the offending site (when
    one can be named), and the full actionable message."""

    code: str
    severity: str
    site: Optional[str]
    message: str

    def __str__(self):
        where = f" (site '{self.site}')" if self.site else ""
        return f"{self.severity.upper():5s} {self.code}{where}: {self.message}"


class LintResult:
    """Findings of one lint pass.  ``result.ok`` is True when no
    *error*-severity finding exists (warnings don't fail)."""

    def __init__(self, findings, details=None):
        self.findings = list(findings)
        # what the pass measured besides its findings (RPL203: each row's
        # launches and max-abs error)
        self.details = dict(details or {})

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == WARN]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self):
        return {f.code for f in self.findings}

    def __str__(self):
        if not self.findings:
            return "ok: no findings"
        return "\n".join(str(f) for f in self.findings)

    def __repr__(self):
        return (f"LintResult(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)})")

    def raise_if_errors(self):
        errs = self.errors
        if errs:
            raise ReproValueError(
                f"model failed lint with {len(errs)} error(s):\n"
                + "\n".join(str(f) for f in errs),
                code=errs[0].code, site=errs[0].site)
        return self


def _mk_finding(code, severity, site, message):
    # unknown codes stay visible rather than crashing the linter itself
    prefix = f"[{code}] "
    if code in RULES and message.startswith(prefix):
        message = message[len(prefix):]
    return Finding(code, severity, site, message)


def _dedupe(findings):
    seen, out = set(), []
    for f in findings:
        key = (f.code, f.site)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _handler_chain(model):
    """The Messenger instances baked into the model callable, outermost
    first (``substitute(seed(model, 0), data=...)`` -> [substitute, seed])."""
    chain = []
    m = model
    while isinstance(m, Messenger) and m.fn is not None:
        chain.append(m)
        m = m.fn
    return chain


def _finding_from_error(e: ReproError) -> Finding:
    code = e.code or "RPL000"
    sev = RULES[code].severity if code in RULES else ERROR
    return _mk_finding(code, sev, getattr(e, "site", None), str(e))


def _is_float64(value) -> bool:
    if isinstance(value, np.ndarray):
        return value.dtype == np.float64
    return isinstance(value, torch.Tensor) and value.dtype == torch.float64


def _check_float64(tr, findings):
    """RPL010: a float64 array observed or substituted into the model while
    the default dtype is float32.  ``MCMC`` keeps a float64 numpy array
    float64 when it moves the arguments to the device, so the site's
    log-density (and the potential, and its gradient) is silently promoted
    to float64."""
    if torch.get_default_dtype() == torch.float64:
        return
    for name, site in tr.items():
        v = site.get("value")
        data = isinstance(v, np.ndarray) or (
            site["type"] == "sample" and site.get("is_observed"))
        if data and _is_float64(v):
            findings.append(_mk_finding(
                "RPL010", WARN, name,
                f"site '{name}' carries a float64 value in a float32 model: "
                "the executor keeps float64 data float64, so the site's "
                "log-density, the potential and its gradient are silently "
                "promoted to float64. Cast the data to float32 explicitly, "
                "or build the whole model in float64."))


def _check_unmatched_handlers(chain, findings):
    """RPL006 (lint side): after the probe trace, any substitute/condition/
    do data key that matched no site is a dead key — a typo'd name or a
    site the handler cannot see."""
    for h in chain:
        if not isinstance(h, (substitute, condition, do)):
            continue
        data = getattr(h, "data", None)
        if not isinstance(data, dict):
            continue
        for name in sorted(set(data) - h._seen):
            findings.append(_mk_finding(
                "RPL006", ERROR, name,
                f"{type(h).__name__} data key '{name}' matched no site in "
                "the model execution: check the name against "
                "trace(model).get_trace() (sites under `scope` carry a "
                "'prefix/' and blocked sites are invisible to outer "
                "handlers)."))


def _check_baked_handlers(chain, findings):
    """RPL015: a ``seed`` handler baked into the model callable draws from
    the generator it captured when it was built, not from the sampler's
    draw sources: its draws ignore the run's seed and are not restored by a
    resume."""
    for h in chain:
        if isinstance(h, seed):
            findings.append(_mk_finding(
                "RPL015", WARN, None,
                "a `seed` handler is baked into the model callable: it draws "
                "from the generator captured when it was built, which the "
                "run's seed and checkpoint/resume never see, so a resumed "
                "or re-seeded run is not bit-identical. Pass the bare model "
                "and seed it inside the call."))


def _is_concrete(leaf):
    return isinstance(leaf, np.ndarray) or (
        isinstance(leaf, torch.Tensor) and not leaf.is_meta)


def _float_dtype(fn, depth=0):
    """The floating dtype of a distribution's parameters (its base's for a
    wrapper), else the default dtype."""
    for v in vars(fn).values():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.dtype
        if depth < 4 and hasattr(v, "batch_shape") and hasattr(v, "sample"):
            return _float_dtype(v, depth + 1)
    return torch.get_default_dtype()


class _AbstractDraws(Messenger):
    """The abstract pass's draws: a latent sample site that no handler
    valued gets an empty meta tensor of its shape (the distributions draw
    on the CPU from their parameters, which a meta parameter cannot give),
    int64 for a discrete site.  Outermost but for ``trace``, so the enum
    probe, ``substitute`` and ``seed`` act first."""

    def process_message(self, msg):
        if msg["type"] != "sample" or msg["value"] is not None:
            return
        fn = msg["fn"]
        dtype = torch.int64 if getattr(fn, "has_enumerate_support", False) \
            else _float_dtype(fn)
        msg["value"] = torch.empty(fn.shape(msg["kwargs"]["sample_shape"]),
                                   dtype=dtype, device="meta")


def lint_model(model, model_args: Tuple = (), model_kwargs: Optional[dict]
               = None, *, mode: str = "density",
               max_plate_nesting: Optional[int] = None,
               params: Optional[dict] = None, device="cuda") -> LintResult:
    """Lint ``model`` by tracing it once with the inert enum probe.

    ``mode="density"`` (default) checks the model as inference evaluates
    it: seeded with a generator of its own (the global generators and any
    run's draw sources are left as they were), enumerable discrete latents
    auto-marked: the ``log_density`` path of ``MCMC``/``SVI``.
    ``mode="simulate"`` checks it as a bare simulation (no implicit
    seeding), which is how the unseeded-latent rule (RPL009) and the
    unseeded-subsample rule (RPL012) become reachable.

    ``max_plate_nesting`` cross-checks the enumeration dim budget the caller
    intends to run with (RPL003).  ``params`` are substituted *outside* the
    enumeration machinery, as ``log_density(model, args, kwargs, params)``
    does, so a param targeting an enumerated site surfaces as RPL008 and a
    dead param key as RPL006.  numpy arguments become tensors (dtype kept)
    and every argument moves to ``device``, as ``MCMC`` moves them: the
    card by default (RPL502 when there is none), the CPU with
    ``device="cpu"``.  Tensors on the ``meta`` device stay where they are
    and make the trace abstract: no arithmetic on the data, and value rules
    skip them; arguments with no concrete array need no device, so the
    abstract pass runs anywhere.
    """
    from .infer.mcmc import _to_device
    from .infer.hmc import resolve_device
    if mode not in ("density", "simulate"):
        raise ValueError(f"unknown lint mode {mode!r}")
    args, kwargs = tuple(model_args), dict(model_kwargs or {})
    leaves = tree_leaves((args, kwargs))
    if any(_is_concrete(leaf) for leaf in leaves):
        device = resolve_device(device)
        args, kwargs = _to_device(args, device), _to_device(kwargs, device)
    findings: list = []
    abstract = any(isinstance(leaf, torch.Tensor) and leaf.is_meta
                   for leaf in leaves)
    devices = [torch.cuda.current_device()] \
        if torch.cuda.is_initialized() else []
    try:
        # the probe draws from its own generator; fork_rng keeps a model
        # that draws from the global ones from moving them
        with torch.random.fork_rng(devices=devices):
            _run_model_rules(model, args, kwargs, mode, max_plate_nesting,
                             params, findings, abstract)
    except ReproError as e:
        findings.append(_finding_from_error(e))
    except Exception as e:  # noqa: BLE001 — any trace crash is a finding
        findings.append(Finding(
            "RPL000", ERROR, None,
            f"model failed to trace: {type(e).__name__}: {e}"))
    return LintResult(_dedupe(findings))


def _run_model_rules(model, args, kwargs, mode, max_plate_nesting, params,
                     findings, abstract=False):
    from .infer.enum import _EnumProbe, _first_available_dim
    from .infer.enum import config_enumerate
    from .infer.enum import enum as _enum

    chain = _handler_chain(model)
    _check_baked_handlers(chain, findings)

    def _with_params(runner):
        # params apply outside the enum machinery, exactly as log_density
        # substitutes them, so RPL008's geometry is preserved
        return substitute(runner, data=params) if params is not None \
            else runner

    def _runner():
        marked = config_enumerate(model)
        return seed(marked, torch.Generator().manual_seed(0)) \
            if mode == "density" else marked

    def _traced(runner):
        return trace(_AbstractDraws(runner) if abstract else runner)

    probe = _EnumProbe(_runner())
    param_sub = _with_params(probe)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = _traced(param_sub).get_trace(*args, **kwargs)
    for w in caught:
        code = warning_code(w.message)
        if code:
            sev = RULES[code].severity if code in RULES else WARN
            findings.append(_mk_finding(code, sev, None, str(w.message)))

    if probe.found:
        if max_plate_nesting is not None \
                and probe.max_plate_nesting > max_plate_nesting:
            findings.append(_mk_finding(
                "RPL003", ERROR, None,
                f"the model uses {probe.max_plate_nesting} plate/batch "
                f"dim(s) but max_plate_nesting={max_plate_nesting}: "
                "enumeration dims would land on plate dims and corrupt the "
                f"marginal. Pass max_plate_nesting="
                f"{probe.max_plate_nesting} (or more)."))
        else:
            # re-trace under a real enum handler at the caller's budget so
            # allocator collisions (RPL003) surface as log_density hits them
            fad = _first_available_dim(probe, max_plate_nesting)
            try:
                _traced(_with_params(_enum(
                    _runner(), first_available_dim=fad))).get_trace(
                    *args, **kwargs)
            except ReproError as e:
                findings.append(_finding_from_error(e))

    extra = [param_sub] if params is not None else []
    _check_unmatched_handlers(chain + extra, findings)
    _check_float64(tr, findings)


# ---------------------------------------------------------------------------
# layer 2: hazards in the dispatched aten ops
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# ops whose result the host must read before it can go on: a scalar read,
# or an output whose shape depends on the data
_HOST_READS = {
    _aten._local_scalar_dense.default: "a scalar read (.item(), bool(), "
                                       "float() of a tensor)",
    _aten.nonzero.default: "a data-dependent shape (nonzero)",
    _aten.masked_select.default: "a data-dependent shape (masked_select)",
    _aten._unique2.default: "a data-dependent shape (unique)",
    _aten.unique_dim.default: "a data-dependent shape (unique)",
    _aten.unique_consecutive.default: "a data-dependent shape (unique)",
}
# indexing by a boolean mask: the number of selected elements decides the
# output's shape (``index``) or the scatter (``index_put``)
_MASK_INDEXING = (_aten.index.Tensor, _aten.index_put.default,
                  _aten.index_put_.default, _aten._index_put_impl_.default)
_COPIES = (_aten._to_copy.default, _aten.copy_.default)
_FRAME_SKIP = (torch.__file__.rsplit("/", 1)[0], __file__)


def _registered_codes():
    """The code objects of every registered op's kernel, plain version and
    public wrapper: a call of one is one node of :func:`count_eqns`."""
    from ..kernels import ops
    specs = list(ops.OP_TABLE) + list(ops.FUSED.values()) \
        + list(ops.BACKWARD.values())
    names = {s.name for s in specs} | {a for s in specs for a in s.also}
    fns = [f for s in specs for f in (s.kernel, s.ref)] \
        + [getattr(ops, n, None) for n in names]
    return {f.__code__ for f in fns if hasattr(f, "__code__")}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t):
    return t.numel() * t.element_size()


class _Recorder(TorchDispatchMode):
    """Records the aten ops of one execution: the op count (a registered
    kernel op's call as one node), large tensors read that the call was
    neither given nor made, host reads with the Python line that made them
    (outside sanctioned functions) and narrowing float conversions."""

    def __init__(self, arguments, const_bytes_limit):
        super().__init__()
        from ..obs import _SANCTIONED_CODE
        self.sanctioned = _SANCTIONED_CODE
        self.registered = _registered_codes()
        self.limit = const_bytes_limit
        self.given = {id(t) for t in arguments} | {
            id(t._base) for t in arguments if t._base is not None}
        # strong references keep the ids in ``given`` from being reused
        self.keep = list(arguments)
        # id -> weakref of every tensor an op made (ids of dead tensors are
        # dropped with them, so a reused id never matches)
        self.made = {}
        self.closed, self.reads, self.narrowing = [], [], []
        self.count = 0
        self._node = None  # the frame of the registered op being counted

    def _frames(self):
        frame = sys._getframe(2)
        while frame is not None:
            yield frame
            frame = frame.f_back

    def _where(self):
        for frame in self._frames():
            if not frame.f_code.co_filename.startswith(_FRAME_SKIP):
                return f"{frame.f_code.co_filename}:{frame.f_lineno}"
        return "?"

    def _sanctioned(self):
        return any(f.f_code in self.sanctioned for f in self._frames())

    def _count(self):
        outer = None
        for frame in self._frames():
            if frame.f_code in self.registered:
                outer = frame
        if outer is None:
            self.count += 1
        elif outer is not self._node:
            self._node = outer
            self.count += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._count()
        inputs = _tensors((args, kwargs))
        for t in inputs:
            root = t if t._base is None else t._base
            if id(root) not in self.given and id(root) not in self.made \
                    and _nbytes(root) > self.limit \
                    and all(root is not c for c in self.closed):
                self.closed.append(root)
        read = _HOST_READS.get(func)
        if func in _MASK_INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            read = "a data-dependent shape (a boolean mask index)"
        if read is not None and not self._sanctioned():
            self.reads.append((read, self._where()))
        out = func(*args, **kwargs)
        if func in _COPIES:
            src, dst = (args[0], out) if func is _COPIES[0] \
                else (args[1], args[0])
            if src.device.type != "cpu" and dst.device.type == "cpu" \
                    and not self._sanctioned():
                self.reads.append(("a copy to the CPU", self._where()))
            if src.is_floating_point() and dst.is_floating_point() \
                    and dst.element_size() < src.element_size():
                self.narrowing.append((src.dtype, dst.dtype, self._where()))
        for t in _tensors(out):
            if id(t) not in self.made:
                self.made[id(t)] = weakref.ref(
                    t, lambda _, i=id(t): self.made.pop(i, None))
            if t._base is not None and id(t._base) in self.given:
                self.given.add(id(t))
                self.keep.append(t)
        return out


def _record(fn, args, kwargs, const_bytes_limit=1 << 20):
    recorder = _Recorder(_tensors((args, kwargs)), const_bytes_limit)
    with recorder:
        fn(*args, **kwargs)
    return recorder


def _sites(entries, limit=5):
    where = list(dict.fromkeys(entries))
    more = f" and {len(where) - limit} more" if len(where) > limit else ""
    return ", ".join(where[:limit]) + more


def analyze(fn: Callable, *args, const_bytes_limit: int = 1 << 20,
            **kwargs) -> LintResult:
    """Record one execution of ``fn(*args, **kwargs)`` and report hazards.

    - RPL101: a tensor larger than ``const_bytes_limit`` that an op reads
      but that is neither an argument (or a view of one) nor made during
      the call: state the function closes over, which every call reads
      where the caller cannot see or replace it.
    - RPL102: a device->host read (``aten._local_scalar_dense``: ``.item()``
      and its kin; a copy to the CPU; an op whose output shape depends on
      the data) made outside the frames of a function marked with
      :func:`repro_torch.obs.sanction`.  Scalar reads and data-dependent
      shapes are reported on every device: on the CPU they are the reads a
      card would make.
    - RPL103: a float conversion to a narrower dtype.

    The call runs once, on the tensors given (their device decides where).
    """
    rec = _record(fn, args, kwargs, const_bytes_limit)
    findings = []
    for c in rec.closed:
        findings.append(_mk_finding(
            "RPL101", WARN, None,
            f"a {_nbytes(c)}-byte tensor (shape {tuple(c.shape)}, dtype "
            f"{c.dtype}) is closed over by the function: pass it as an "
            "argument so the caller sees and can replace what every call "
            "reads."))
    if rec.reads:
        kinds = sorted({k for k, _ in rec.reads})
        findings.append(_mk_finding(
            "RPL102", WARN, None,
            f"{len(rec.reads)} device->host read(s) in one call "
            f"({'; '.join(kinds)}) at {_sites(w for _, w in rec.reads)}: "
            "each synchronizes the host with the device. Keep them out of "
            "sampling/density hot paths, or mark a chunk-boundary drain "
            "with repro_torch.obs.sanction."))
    if rec.narrowing:
        old, new, _ = rec.narrowing[0]
        findings.append(_mk_finding(
            "RPL103", WARN, None,
            f"precision-losing conversion {old} -> {new} inside the "
            f"function at {_sites(w for _, _, w in rec.narrowing)}: if "
            "this is not an intentional mixed-precision cast, a float64/"
            "float32 input is being silently narrowed."))
    return LintResult(_dedupe(findings))


def count_eqns(fn: Callable, *args, **kwargs) -> int:
    """The number of aten ops one call of ``fn(*args, **kwargs)``
    dispatches, each call of a registered kernel op (``ops.OP_TABLE``,
    ``FUSED``, ``BACKWARD``: its kernel, plain version or public wrapper)
    counted as one node whichever route it took, so the CPU's plain chain
    counts as the card's one launch."""
    return _record(fn, args, kwargs).count


def check_time_independence(make_fn: Callable, sizes: Tuple[int, ...]
                            = (4, 8)) -> LintResult:
    """RPL104: a chain program's op count must not grow with T.

    ``make_fn(T) -> (fn, args)`` builds the program at one time-axis
    length.  ``markov`` eliminates the chain in one ``ops.enum_chain`` call
    after one vectorized pass over the steps, so one call of the program
    must dispatch the *same* number of ops at every T — growth means the
    chain got unrolled (O(T) Python work and launches per call).
    """
    counts = {}
    for t in sizes:
        fn, args = make_fn(t)
        counts[t] = count_eqns(fn, *args)
    findings = []
    if len(set(counts.values())) != 1:
        findings.append(_mk_finding(
            "RPL104", ERROR, None,
            f"program size grows with the time axis: op counts {counts}. "
            "markov chains must eliminate through ops.enum_chain "
            "(T-independent program, O(T*K^2) work) — check for Python "
            "loops over time steps."))
    return LintResult(findings)


__all__ = [
    "Finding",
    "LintResult",
    "RULES",
    "analyze",
    "check_time_independence",
    "count_eqns",
    "lint_model",
]
