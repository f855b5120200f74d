"""RPL2xx: the machine-checked kernel-registry and ``KernelSetup``
invariants (the JAX package's ``repro.lint_rules.invariants``).

- **The op registry**, ``kernels/ops.py``'s ``OP_TABLE``, ``FUSED`` and
  ``BACKWARD``:

  - RPL201 (:func:`check_registry_completeness`): the rows of ``OP_TABLE``
    and ``FUSED`` (with each row's ``also`` entries) are in bijection with
    the public ops of ``ops.py`` (its launch-counter controls excluded);
    every row's plain version is callable, and so is its kernel where it
    has one (a row with a TPU kernel must); every ``BACKWARD`` row has its
    forward row.
  - RPL202 (:func:`check_signatures`): the public wrapper's parameter names
    are the contract; the kernel and the plain version each start with
    them, in order, and any extra parameter has a default.  A ``BACKWARD``
    row has no public wrapper: its kernel is held to its plain version.
  - RPL203 (:func:`check_parity`): the kernel and its plain version run on
    the card on the same inputs (:func:`_sample_inputs`, small shapes from
    the port's card tests) and agree within the row's bound:
    ``bit_identical`` rows bit for bit, a bfloat16 output within one
    bfloat16 step (``BF16_RTOL``/``BF16_ATOL``), the rest within ``tol``
    max-abs, or of each output's largest entry for a ``relative`` row, and
    for a row with a ``scale`` (an accept probability, the exp of a sum)
    within ``expm1(tol x scale)`` of the terms it sums; the arguments are
    compared after the calls too (some kernels write in place).  The check
    moves the kernels' launch counters: callers read them from
    ``ops.reset_launch_counts()``.  There is no interpret mode for a CUDA kernel, so without a
    card it raises ``RPL502``, as the port's entry points do: it never
    compares the plain version with itself.

- **The KernelSetup field contract** (RPL204, :func:`verify_kernel_setup`):
  callable closures, an integer ``num_warmup``, an ``adapt_schedule`` of
  int pairs, a bool ``cross_chain``, ``init_batch_fn`` and
  ``sample_batch_fn`` given both or neither, a ``data_axis`` coherent with
  the potential's ``data_shards`` marker (``core/infer/glm.py``), and, for
  a cross-chain kernel, matrix-shaped state leaves leading with the chain
  axis.  Of the JAX package's checks, hashability is kept: the port keys
  nothing on the setup for compilation, but ``MCMC.run`` hashes it into the
  telemetry manifest's ``kernel_setup_hash``.
"""
from __future__ import annotations

import inspect
import math
import zlib

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..core.errors import NO_DEVICE, ReproRuntimeError
from ..kernels import enum_contract as _enum_contract
from ..kernels import flash_attention as _flash
from ..kernels import ops
from ..kernels import softmax_xent as _xent
from . import ERROR


def _mk(code, site, message):
    from ..core.lint import Finding
    return Finding(code, ERROR, site, message)


def _result(findings, details=None):
    from ..core.lint import LintResult
    return LintResult(findings, details)


def _rows():
    """Every registered row: the op table, the fused ops, the backward
    kernels."""
    return list(ops.OP_TABLE) + list(ops.FUSED.values()) \
        + list(ops.BACKWARD.values())


def _param_names(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()]


# ---------------------------------------------------------------------------
# RPL203: sample inputs, one factory per row with a kernel
# ---------------------------------------------------------------------------

def _sample_inputs(name, device):
    """Small inputs exercising row ``name``'s kernel at the dtypes its main
    path gives it, made afresh on every call (the same values each time,
    from a generator seeded by the name): ``(args, kwargs)``, or None for a
    row with no factory.  Shapes follow the port's card tests
    (``tests/test_torch_cuda.py``), every sampler row in float32, as the
    main path launches it."""
    gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, dtype=f32)
                .double()).to(dtype).to(device)

    def rand(*shape, dtype=f32, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen)
                ).to(dtype).to(device)

    def dev(t):
        return t.to(device)

    if name in ("attention", "attention_dq", "attention_dkv"):
        b, s, h, k, d = 1, 128, 2, 1, 64
        q, kk, v = (randn(b, s, h_, d, dtype=bf16) for h_ in (h, k, k))
        if name == "attention":
            return (q, kk, v), {"causal": True}
        o, lse = (t.contiguous() for t in
                  _flash.flash_attention_ref(q, kk, v, causal=True))
        do = randn(b, s, h, d, dtype=bf16)
        if name == "attention_dq":
            return (q, kk, v, o, lse, do), {"causal": True}
        delta = _flash.flash_attention_dq_ref(q, kk, v, o, lse, do,
                                              True)[1].contiguous()
        return (q, kk, v, lse, delta, do), {"causal": True}
    if name == "leapfrog_halfstep":
        d = 515  # not a multiple of a block: the tail
        return (randn(d), randn(d), randn(d), rand(d, lo=0.5, hi=2.0),
                dev(torch.tensor(0.1))), {}
    if name in ("leapfrog_halfstep_batch", "mala_step", "chees_open"):
        c, d = (5, 515) if name != "chees_open" else (8, 54)
        z, r, g = randn(c, d), randn(c, d), randn(c, d)
        m = rand(d, lo=0.5, hi=2.0)
        if name == "leapfrog_halfstep_batch":
            return (z, r, g, m, 0.1, 1.0), {}
        if name == "mala_step":
            return (z, g, r, m, 0.05), {}
        return (z, r, g, m, 0.0123), {}
    if name in ("glm_potential_grad", "glm_potential_partials"):
        n, d = 300, 7  # rows over more than one block, d under a lane
        x, w = randn(n, d), randn(d, scale=0.3)
        y = (rand(n) < 0.5).float()
        off = randn(n, scale=0.1)
        kw = {"data_shards": 3} if name == "glm_potential_partials" else {}
        return (x, y, w, off, None, "bernoulli_logit"), kw
    if name in ("enum_contract", "enum_contract_bwd"):
        a, m = randn(7), randn(7, 5)
        if name == "enum_contract":
            return (a, m), {}
        out = _enum_contract.enum_contract_ref(a, m)
        return (a, m, out, randn(5)), {}
    if name in ("enum_chain", "enum_chain_sample", "enum_chain_bwd"):
        T, K = 12, 8
        a, m = randn(K), randn(T - 1, K, K)
        if name == "enum_chain":
            return (a, m), {}
        alphas = _enum_contract.enum_chain_ref(a, m)
        if name == "enum_chain_bwd":
            return (m, alphas, randn(K)), {}
        u = rand(T, K, lo=1e-6, hi=1.0)
        return (alphas, m, -torch.log(-torch.log(u))), {}
    if name in ("rmsnorm", "rmsnorm_bwd"):
        x = randn(4, 64, 128, dtype=bf16)
        w = rand(128, lo=0.5, hi=1.5)
        if name == "rmsnorm":
            return (x, w), {}
        return (x, w, randn(4, 64, 128, dtype=bf16)), {}
    if name in ("softmax_xent", "softmax_xent_bwd"):
        t, d, v = 128, 32, 512
        x = randn(t, d, dtype=bf16, scale=0.5)
        w = randn(d, v, dtype=bf16, scale=0.5)
        labels = dev(torch.randint(0, v, (t,), generator=gen,
                                   dtype=torch.int32))
        if name == "softmax_xent":
            return (x, w, labels), {"z_loss_weight": 1e-4}
        lse = _xent.softmax_xent_ref(x, w, labels, 1e-4)[2]
        g_ce, g_zl = rand(t, lo=0.5, hi=1.5), rand(t, lo=0.5, hi=1.5)
        return (x, w, labels, lse, g_ce, g_zl, 1e-4), {}
    if name == "ssd_scan":
        b, length, h, p, g, n = 1, 64, 2, 16, 1, 16
        x = randn(b, length, h, p, dtype=bf16, scale=0.5)
        dt = rand(b, length, h, lo=1e-3, hi=0.1)
        A = -rand(h, lo=1.0, hi=16.0)
        B = randn(b, length, g, n, dtype=bf16, scale=0.3)
        C = randn(b, length, g, n, dtype=bf16, scale=0.3)
        return (x, dt, A, B, C), {"chunk": 32, "D": rand(h, lo=0.5,
                                                        hi=1.5)}
    if name in ("nuts_leaf", "nuts_turning"):
        d = 54  # the logreg's dimension
        m = rand(d, lo=0.5, hi=1.5)
        if name == "nuts_turning":
            return (m, randn(d), randn(d), randn(d, scale=3.0)), {}
        r_half, z, g, r_sum = (randn(d) for _ in range(4))
        ck, sck = randn(8, d), randn(8, d, scale=2.0)
        pe, eps = dev(torch.tensor(1.75)), dev(torch.tensor(0.0123))
        return (r_half, z, g, pe, m, eps, r_sum, ck, sck, None, 0, 3), {}
    if name in ("nuts_leaf_batch", "nuts_turning_batch", "halfstep_chains"):
        c, d = 3, 54
        m = rand(c, d, lo=0.5, hi=1.5)
        if name == "nuts_turning_batch":
            return (m, randn(c, d), randn(c, d), randn(c, d, scale=3.0)), {}
        eps = dev(torch.tensor([0.0123, -0.0123, 0.0123]))
        active = dev(torch.tensor([True, True, False]))
        z, r, g = randn(c, d), randn(c, d), randn(c, d)
        if name == "halfstep_chains":
            return (z, r, g, m, eps, active), {}
        ck, sck = randn(c, 8, d), randn(c, 8, d, scale=2.0)
        return (r, z, g, randn(c, scale=3.0), m, eps, active, randn(c, d),
                ck, sck, None, 0, 3), {}
    if name == "mala_accept":
        c, d, eps = 8, 54, 0.0071
        coef = float(np.float32(-0.25) / np.float32(eps))
        z, g, noise = randn(c, d), randn(c, d), randn(c, d)
        m = rand(d, lo=0.5, hi=1.5)
        z_new = z - eps * m * g + torch.sqrt(2 * eps * m) * noise
        g_new = g + randn(c, d, scale=0.2)
        pe = randn(c, scale=3.0).abs()
        pe_new = pe + randn(c, scale=0.5)
        u, mean = rand(c), rand(c)
        return (z, pe, g, z_new, pe_new, g_new, noise, m, u, eps, coef, mean,
                7), {}
    if name == "chees_accept":
        c, d = 8, 54
        z0, g0, n = (randn(c, d) for _ in range(3))
        m = rand(d, lo=0.5, hi=1.5)
        z1, r = randn(c, d), randn(c, d)
        g1 = g0 + randn(c, d, scale=0.2)
        pe0 = randn(c, scale=3.0).abs()
        r0, r1 = n / torch.sqrt(m), r - 0.5 * 0.0123 * g1
        pe1 = pe0 + 0.5 * ((r0 * m * r0).sum(-1) - (r1 * m * r1).sum(-1)) \
            + randn(c, scale=0.5)
        eps = dev(torch.tensor([0.0123]))
        u, mean = rand(c), rand(c)
        return (z0, pe0, g0, n, m, z1, r, pe1, g1, eps, u, 1000.0, mean,
                7), {}
    return None


# ---------------------------------------------------------------------------
# RPL201 / RPL202
# ---------------------------------------------------------------------------

def _public_ops():
    return {n for n, f in inspect.getmembers(ops, inspect.isfunction)
            if not n.startswith("_") and f.__module__ == ops.__name__} \
        - ops._CONTROL


def check_registry_completeness():
    """RPL201: the registry rows in bijection with ``ops.py``'s public ops,
    every entry callable, every backward row with its forward row."""
    findings = []
    rows = list(ops.OP_TABLE) + list(ops.FUSED.values())
    table = {s.name for s in rows} | {a for s in rows for a in s.also}
    public = _public_ops()
    for name in sorted(public - table):
        findings.append(_mk(
            "RPL201", name,
            f"op '{name}' is dispatched by kernels/ops.py but has no "
            "registry row: add it to OP_TABLE or FUSED with its kernel and "
            "plain version (or to a row's `also` when it runs that row's "
            "kernel)."))
    for name in sorted(table - public):
        findings.append(_mk(
            "RPL201", name,
            f"registry entry '{name}' matches no public op in "
            "kernels/ops.py: remove the stale entry or restore the op."))
    for spec in _rows():
        if not callable(spec.ref):
            findings.append(_mk(
                "RPL201", spec.name,
                f"op '{spec.name}' has no callable plain version "
                f"(ref={spec.ref!r})."))
        # a row with a route (or a TPU kernel it replaces) needs a kernel;
        # a ref-only row has neither
        needs_kernel = spec.route is not None or spec.replaces is not None
        if (needs_kernel or spec.kernel is not None) \
                and not callable(spec.kernel):
            findings.append(_mk(
                "RPL201", spec.name,
                f"op '{spec.name}' has no callable kernel "
                f"(kernel={spec.kernel!r})."))
    forward = {s.name for s in rows}
    for name in sorted(ops.BACKWARD):
        if not any(name.startswith(f + "_") for f in forward):
            findings.append(_mk(
                "RPL201", name,
                f"backward row '{name}' has no forward row: its name must "
                "extend a row of OP_TABLE or FUSED (`<op>_...`)."))
    return _result(findings)


def check_signatures(spec):
    """RPL202 for one row: the public wrapper's parameter names (each of
    its ``also`` wrappers too) are the contract, and the kernel and the
    plain version each start with them, any extra with a default.  A
    ``BACKWARD`` row has no wrapper: its kernel is held to its plain
    version."""
    findings = []
    wrappers = [getattr(ops, n, None) for n in (spec.name,) + spec.also]
    contracts = [(f"wrapper ops.{n}", w) for n, w in
                 zip((spec.name,) + spec.also, wrappers) if w is not None]
    candidates = [("kernel", spec.kernel), ("plain version", spec.ref)]
    if not contracts:
        contracts = [("plain version", spec.ref)]
        candidates = candidates[:1]
    for label, contract in contracts:
        names = _param_names(contract)
        for what, fn in candidates:
            if fn is None:
                continue
            got = _param_names(fn)
            if got[:len(names)] != names:
                findings.append(_mk(
                    "RPL202", spec.name,
                    f"op '{spec.name}': the {what}'s parameters {got} do not "
                    f"start with the {label}'s {names}: the two paths must "
                    "be drop-in interchangeable."))
                continue
            params = inspect.signature(fn).parameters
            for extra in got[len(names):]:
                if params[extra].default is inspect.Parameter.empty:
                    findings.append(_mk(
                        "RPL202", spec.name,
                        f"op '{spec.name}': the {what}'s extra parameter "
                        f"'{extra}' has no default: parameters beyond the "
                        f"{label}'s must be optional."))
    return _result(findings)


# ---------------------------------------------------------------------------
# RPL203: parity on the card
# ---------------------------------------------------------------------------

def _leaves(tree):
    return [leaf for leaf in tree_leaves(tree) if leaf is not None]


def _disagreement(spec, got, want, scale=0.0):
    """None when ``got`` (the kernel's) is within the row's bound of
    ``want`` (the plain version's), else the reason; plus the max-abs
    error.  ``scale`` is the largest magnitude of the terms a ``scale``
    row sums (``spec.scale`` of the inputs)."""
    if not isinstance(got, torch.Tensor) or not isinstance(want,
                                                           torch.Tensor):
        same = type(got) is type(want) and got == want
        return (None if same else f"{got!r} != {want!r}"), 0.0
    if got.shape != want.shape or got.dtype != want.dtype:
        return (f"{got.dtype} {tuple(got.shape)} != {want.dtype} "
                f"{tuple(want.shape)}"), float("inf")
    if not (got.is_floating_point() or got.is_complex()):
        same = torch.equal(got, want)
        return (None if same else "integer/bool values differ"), \
            0.0 if same else float("inf")
    a, b = got.double(), want.double()
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return "NaN at other places", float("inf")
    a, b = a[~nan], b[~nan]
    inf = a.isinf()
    if not torch.equal(a[inf], b[inf]) or not torch.equal(inf, b.isinf()):
        return "infinities differ", float("inf")
    a, b = a[~inf], b[~inf]
    err = float((a - b).abs().max()) if a.numel() else 0.0
    if spec.bit_identical:
        same = torch.equal(a, b)
        return (None if same else "declared bit-identical but differs"), err
    if got.dtype == torch.bfloat16:
        ok = bool(((a - b).abs() <= ops.BF16_RTOL * b.abs()
                   + ops.BF16_ATOL).all())
        return (None if ok else "beyond one bfloat16 step"), err
    bound = spec.tol
    if spec.relative and b.numel():
        bound *= max(1.0, float(b.abs().max()))
    # the sums move by tol of their terms' magnitudes, an exp of them (at
    # most 1) by expm1 of that
    bound = max(bound, math.expm1(spec.tol * scale))
    return (None if err <= bound else
            f"max abs error {err} exceeds the bound {bound}"), err


class _NoTf32:
    """float32 matmuls in full float32 while a parity check runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def _card(device):
    """The card parity runs on: RPL502 when there is none (a CUDA kernel
    has no interpret mode, and the plain version against itself proves
    nothing)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise ReproRuntimeError(
            f"RPL203 runs each kernel against its plain version on a card; "
            f"device {str(device)!r} is not one"
            + ("" if torch.cuda.is_available() else
               " and torch.cuda is not available"),
            code=NO_DEVICE)
    return device


def check_parity(spec, device="cuda"):
    """RPL203 for one row: the kernel and the plain version on the same
    fresh inputs on the card, every output (and every argument after the
    calls) within the row's bound; the kernel must have launched.  A row
    with a kernel and no input factory is itself a finding.  ``details``
    holds the row's launches and max-abs error.  The kernel's launch counter
    moves with its launches here: callers that read counters reset them
    (``ops.reset_launch_counts()``)."""
    device = _card(device)
    findings = []
    if spec.kernel is None:
        return _result(findings)
    inputs = _sample_inputs(spec.name, device)
    if inputs is None:
        findings.append(_mk(
            "RPL203", spec.name,
            f"op '{spec.name}' has a kernel but no sample-input factory: "
            "add one to lint_rules.invariants._sample_inputs so parity is "
            "actually executed."))
        return _result(findings)
    k_args, kwargs = inputs
    p_args, _ = _sample_inputs(spec.name, device)
    # from the inputs before the calls (some kernels write in place)
    scale = float(spec.scale(*p_args, **kwargs).max()) \
        if spec.scale is not None else 0.0
    before = getattr(spec.kernel, "launches", None)
    with _NoTf32():
        got = spec.kernel(*k_args, **kwargs)
        want = spec.ref(*p_args, **kwargs)
        torch.cuda.synchronize(device)
    launched = None
    if before is not None:
        launched = spec.kernel.launches - before
        if launched < 1:
            findings.append(_mk(
                "RPL203", spec.name,
                f"op '{spec.name}': the kernel did not launch (its counter "
                "did not move)."))
    worst = 0.0
    pairs = zip(_leaves((got, k_args)), _leaves((want, p_args)))
    for i, (a, b) in enumerate(pairs):
        why, err = _disagreement(spec, a, b, scale)
        worst = max(worst, err)
        if why is not None:
            findings.append(_mk(
                "RPL203", spec.name,
                f"op '{spec.name}' output {i}: kernel vs plain version: "
                f"{why}."))
    return _result(findings, {spec.name: {"launches": launched,
                                          "max_abs_err": worst}})


def verify_registry(parity: bool = True, device="cuda"):
    """RPL201, RPL202 and (``parity=True``, on a card) RPL203 over every
    row of ``OP_TABLE``, ``FUSED`` and ``BACKWARD`` in one pass; parity
    raises RPL502 without a card."""
    if parity:
        device = _card(device)
    findings = list(check_registry_completeness().findings)
    details = {}
    for spec in _rows():
        findings.extend(check_signatures(spec).findings)
        if parity:
            result = check_parity(spec, device)
            findings.extend(result.findings)
            details.update(result.details)
    return _result(findings, details)


# ---------------------------------------------------------------------------
# RPL204: the KernelSetup field contract
# ---------------------------------------------------------------------------

_SETUP_CALLABLES = ("init_fn", "sample_fn", "collect_fn", "potential_fn",
                    "unravel_fn", "constrain_fn")


def verify_kernel_setup(setup, state=None, num_chains=None):
    """RPL204: the KernelSetup field contract.

    ``state``/``num_chains`` optionally verify the cross-chain leaf
    contract: matrix-shaped ensemble state leaves must lead with the chain
    axis (scalars and vectors are shared pooled adaptation state).
    """
    findings = []

    def bad(msg):
        findings.append(_mk("RPL204", getattr(setup, "algo", None), msg))

    try:
        hash(setup)
    except TypeError as e:
        bad(f"KernelSetup is not hashable ({e}): MCMC.run hashes the setup "
            "into the run manifest's kernel_setup_hash. Keep every field a "
            "function, int, str, or nested tuple.")
    for field in _SETUP_CALLABLES:
        if not callable(getattr(setup, field, None)):
            bad(f"KernelSetup.{field} is not callable.")
    if not isinstance(getattr(setup, "num_warmup", None), int):
        bad(f"KernelSetup.num_warmup must be a Python int, got "
            f"{type(getattr(setup, 'num_warmup', None)).__name__}: a tensor "
            "warmup length would be read back to the host at every "
            "transition of the schedule.")
    sched = getattr(setup, "adapt_schedule", None)
    ok_sched = isinstance(sched, tuple) and all(
        isinstance(w, tuple) and len(w) == 2
        and all(isinstance(x, int) for x in w) for w in sched)
    if not ok_sched:
        bad("KernelSetup.adapt_schedule must be a tuple of (start, end) "
            f"int pairs, got {sched!r}.")
    if not isinstance(getattr(setup, "cross_chain", None), bool):
        bad("KernelSetup.cross_chain must be a bool.")
    batch = (getattr(setup, "init_batch_fn", None),
             getattr(setup, "sample_batch_fn", None))
    if (batch[0] is None) != (batch[1] is None):
        bad("KernelSetup.init_batch_fn and sample_batch_fn must be given "
            "both or neither: the executor runs chains in lockstep only "
            "with both.")
    elif batch[0] is not None and not all(callable(f) for f in batch):
        bad("KernelSetup.init_batch_fn/sample_batch_fn are not callable.")
    data_axis = getattr(setup, "data_axis", None)
    pot = getattr(setup, "potential_fn", None)
    shards = getattr(pot, "data_shards", None)
    if data_axis is not None:
        if not isinstance(data_axis, str):
            bad(f"KernelSetup.data_axis must be None or a mesh axis name "
                f"(str), got {type(data_axis).__name__}: the executor "
                "matches it against the mesh's dim names.")
        elif not (isinstance(shards, int) and shards >= 1):
            bad(f"KernelSetup.data_axis={data_axis!r} declares a data-"
                "sharded potential, but potential_fn carries no "
                f"data_shards marker (found {shards!r}): the executor "
                "would enter the mesh and evaluate a monolithic potential, "
                "silently losing data parallelism and the resharding "
                "bit-identity guarantee. Build the potential with "
                "data_shards=S (core/infer/glm.py) or drop the axis "
                "declaration.")
    elif isinstance(shards, int) and shards >= 1:
        bad(f"potential_fn is shard-aware (data_shards={shards}) but "
            "KernelSetup.data_axis is None: the executor never activates "
            "the inference mesh, so every shard evaluates locally and the "
            "declared fold parallelism is dead. Declare data_axis='data' "
            "in the setup.")
    if getattr(setup, "cross_chain", False) and state is not None \
            and num_chains is not None:
        # shared pooled state (the iteration counter, step size, the (D,)
        # mass diagonal / Welford moments) is scalar or vector shaped;
        # anything matrix-shaped is per-chain and leads with the chain axis
        for i, leaf in enumerate(_leaves(state)):
            shape = tuple(getattr(leaf, "shape", ()))
            if len(shape) >= 2 and shape[0] != num_chains:
                bad(f"cross_chain state leaf {i} has shape {shape}; "
                    f"matrix-shaped ensemble leaves must lead with the "
                    f"chain axis ({num_chains},).")
    return _result(findings)


__all__ = [
    "check_parity",
    "check_registry_completeness",
    "check_signatures",
    "verify_kernel_setup",
    "verify_registry",
]
