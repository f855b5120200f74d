"""Fused GLM potential and gradient (the logreg / CoverType hot path).

``glm_potential_grad(x, y, w, offset, scale, family)`` returns the negative
log-likelihood of a GLM with linear predictor ``l = x @ w + offset`` and its
gradient with respect to ``w``:

- ``bernoulli_logit``: ``nll_i = softplus(l_i) - y_i * l_i`` (the exact
  negation of ``Bernoulli.log_prob``), gradient ``x^T (sigmoid(l) - y)``;
- ``normal``: ``nll_i = 0.5 ((l_i - y_i)/scale)^2 + log scale +
  0.5 log 2 pi``, gradient ``x^T (l - y) / scale^2``.

``w`` is one weight vector ``(d,)`` -> ``(nll (), grad (d,))``, or the
chains of an ensemble ``(C, d)`` -> ``(nll (C,), grad (C, d))``: the
counterpart of ``jax.vmap`` of the JAX function over ``w``.  Value and
gradient reduce the same residual against the same rows of ``x``, so the
CUDA kernel (``csrc/glm_potential.cu``) reads ``x`` once for value,
gradient and all C chains, and chain ``c`` of a C-chain call is
bit-identical to a call on ``w[c]`` alone.  ``ops.glm_potential_grad``
takes :func:`glm_potential_grad_ref` for CPU tensors and
:func:`glm_potential_grad_cuda` for CUDA tensors, never the other.

``glm_potential_partials(x, y, w, offset, scale, family, data_shards=S)``
splits the n rows into S equal shards and returns each shard's
``glm_potential_grad``: ``(S,)`` / ``(S, d)`` for ``w (d,)``, ``(C, S)`` /
``(C, S, d)`` for ``w (C, d)``.  The JAX package runs its kernel once per
shard; :func:`glm_potential_partials_cuda` runs the same kernel over a
shard grid dimension, so every shard's partials of every chain come from
one launch, each bit-identical to :func:`glm_potential_grad_cuda` on that
shard's rows alone.  :func:`glm_potential_partials_ref` is the loop.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_FAMILIES = {"bernoulli_logit": 0, "normal": 1}
MAX_D = 256     # columns of x the kernel takes
MAX_CHAINS = 256  # chains a launch takes (16 per CTA, 16 chain groups)


def glm_potential_grad_ref(x, y, w, offset=None, scale=None,
                           family="bernoulli_logit", *,
                           compute_dtype=torch.float32):
    """The plain PyTorch version (port of ``repro.kernels.ref.
    glm_potential_grad``): computes in float32 like the kernel, or in
    ``compute_dtype`` where it referees the kernel; returns ``w.dtype``.
    A ``(C, d)`` ``w`` is a loop of the single-chain formula, so each
    chain is bit-identical to a call on its own row."""
    if w.dim() == 2:
        outs = [glm_potential_grad_ref(x, y, wc, offset, scale, family,
                                       compute_dtype=compute_dtype)
                for wc in w]
        return (torch.stack([v for v, _ in outs]),
                torch.stack([g for _, g in outs]))
    xf = x.to(compute_dtype)
    yf = y.to(compute_dtype)
    logits = xf @ w.to(compute_dtype)
    if offset is not None:
        logits = logits + offset.to(compute_dtype)
    if family == "bernoulli_logit":
        nll = torch.sum(F.softplus(logits) - yf * logits)
        resid = torch.sigmoid(logits) - yf
    elif family == "normal":
        s = torch.as_tensor(scale, dtype=compute_dtype, device=x.device)
        zscore = (logits - yf) / s
        nll = torch.sum(0.5 * zscore * zscore + torch.log(s) + _HALF_LOG_2PI)
        resid = (logits - yf) / (s * s)
    else:
        raise ValueError(f"unknown GLM family: {family!r}")
    grad = resid @ xf
    return nll.to(w.dtype), grad.to(w.dtype)


def _split(n, data_shards):
    """Rows a shard of ``n`` rows split into ``data_shards``; raises unless
    they split evenly."""
    shards = int(data_shards)
    if shards < 1 or n % shards != 0:
        raise ValueError(f"n={n} rows do not split into data_shards="
                         f"{data_shards} equal shards")
    return n // shards


def glm_potential_partials_ref(x, y, w, offset=None, scale=None,
                               family="bernoulli_logit", *, data_shards=1,
                               compute_dtype=torch.float32):
    """The plain version (port of ``repro.kernels.glm_potential.
    glm_potential_partials``): :func:`glm_potential_grad_ref` on each of
    the ``data_shards`` equal row shards, stacked -> ``(S,)``/``(S, d)``,
    or ``(C, S)``/``(C, S, d)`` for a ``(C, d)`` ``w``."""
    m = _split(x.shape[0], data_shards)
    outs = [glm_potential_grad_ref(
        x[i * m:(i + 1) * m], y[i * m:(i + 1) * m], w,
        None if offset is None else offset[i * m:(i + 1) * m], scale, family,
        compute_dtype=compute_dtype) for i in range(int(data_shards))]
    axis = w.dim() - 1  # the shard axis follows the chain axis
    return (torch.stack([v for v, _ in outs], axis),
            torch.stack([g for _, g in outs], axis))


def _lib():
    lib = _build.load("glm_potential")
    fn = lib.glm_potential_partials_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        lib.glm_potential_partials_part_floats.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.glm_potential_partials_part_floats.restype = ctypes.c_longlong
        lib.glm_potential_partials_part2_floats.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.glm_potential_partials_part2_floats.restype = ctypes.c_longlong
        lib.glm_potential_partials_ticket_ints.argtypes = [ctypes.c_int]
        lib.glm_potential_partials_ticket_ints.restype = ctypes.c_longlong
        lib.glm_potential_max_chains.restype = ctypes.c_int
        if lib.glm_potential_max_chains() != MAX_CHAINS:
            raise RuntimeError("csrc/glm_potential.cu and MAX_CHAINS differ")
    return lib


# The fold's tickets: zero-initialised ints per (device, stream, shard
# count), which the kernel leaves at zero.  Launches on one stream run in
# order, so they can share them; another stream gets its own.  A stream
# first seen under CUDA graph capture (a graph's capture stream) has its
# tickets zeroed by the captured fill, so that graph is replayed before any
# other captured on that stream.  A buffer is never replaced: a captured
# graph keeps its address.
_TICKETS = {}


def _tickets(lib, device, stream, shards=1):
    key = (device.index, stream, shards)
    buf = _TICKETS.get(key)
    if buf is None:
        buf = torch.zeros(lib.glm_potential_partials_ticket_ints(shards),
                          dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def _launch(name, x, y, w, offset, scale, family, shards):
    """Check the operands and launch the kernel once over ``shards`` equal
    row shards -> ``(nll (C, S), grad (C, S, d), C)`` float32."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown GLM family: {family!r}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    n, d = x.shape
    if n == 0 or not 0 < d <= MAX_D:
        raise ValueError(f"{name} takes n >= 1 and 1 <= d <= {MAX_D}, got "
                         f"x of shape {(n, d)}")
    m = _split(n, shards)
    checks = [("x", x, (n, d)), ("y", y, (n,))]
    if offset is not None:
        checks.append(("offset", offset, (n,)))
    for arg, t, shape in checks:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} is {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); expected contiguous "
                f"float32 {shape} on {x.device}")
    chains = w.shape[0] if w.dim() == 2 else 1
    if (w.device != x.device or w.dim() not in (1, 2) or w.shape[-1] != d
            or w.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"{name}: w is {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}; expected float ({d},) or (C, {d}) on "
                         f"{x.device}")
    if not 1 <= chains <= MAX_CHAINS:
        raise ValueError(f"{name} takes 1 to {MAX_CHAINS} chains, got w of "
                         f"shape {tuple(w.shape)}")
    if family == "normal":
        if scale is None or isinstance(scale, torch.Tensor):
            raise TypeError(f"{name} takes the Normal scale as a Python "
                            "number")
        scale = float(scale)
    else:
        scale = 1.0
    wf = w.to(torch.float32).reshape(chains, d).contiguous()
    lib = _lib()
    dev = x.device
    part = torch.empty(
        lib.glm_potential_partials_part_floats(m, d, chains, shards),
        dtype=torch.float32, device=dev)
    part2 = torch.empty(
        lib.glm_potential_partials_part2_floats(d, chains, shards),
        dtype=torch.float32, device=dev)
    nll = torch.empty((chains, shards), dtype=torch.float32, device=dev)
    grad = torch.empty((chains, shards, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets(lib, dev, stream, shards)
    with torch.cuda.device(dev):
        rc = lib.glm_potential_partials_f32(
            x.data_ptr(), y.data_ptr(),
            None if offset is None else offset.data_ptr(), wf.data_ptr(),
            scale, _FAMILIES[family], m, d, chains, shards, part.data_ptr(),
            part2.data_ptr(), tickets.data_ptr(), nll.data_ptr(),
            grad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return nll, grad, chains


def glm_potential_grad_cuda(x, y, w, offset=None, scale=None,
                            family="bernoulli_logit"):
    """Launch the CUDA kernel once on the current stream: every chain's
    nll and gradient from one read of ``x``, folded in a fixed order.

    ``x``, ``y`` and ``offset`` must be contiguous float32 on one card with
    ``d <= MAX_D``; ``w`` is ``(d,)`` or ``(C, d)`` with ``C <= MAX_CHAINS``,
    float32 or float64 (the kernel computes in float32 and the result comes
    back in ``w.dtype``).  ``scale`` is a Python number (the Normal noise
    scale, fixed at setup).  Raises on anything else, and on a failed build
    or launch.  ``.launches`` counts calls, ``.chain_evals`` the chains
    they evaluated.
    """
    nll, grad, chains = _launch("glm_potential_grad_cuda", x, y, w, offset,
                                scale, family, 1)
    glm_potential_grad_cuda.launches += 1
    glm_potential_grad_cuda.chain_evals += chains
    nll, grad = nll[:, 0], grad[:, 0]
    if w.dim() == 1:
        nll, grad = nll[0], grad[0]
    return nll.to(w.dtype), grad.to(w.dtype)


glm_potential_grad_cuda.launches = 0
glm_potential_grad_cuda.chain_evals = 0


def glm_potential_partials_cuda(x, y, w, offset=None, scale=None,
                                family="bernoulli_logit", *, data_shards=1):
    """Launch the CUDA kernel once over ``data_shards`` equal row shards:
    every shard's partials of every chain, ``(S,)``/``(S, d)`` for ``w
    (d,)``, ``(C, S)``/``(C, S, d)`` for ``w (C, d)``, shard ``z`` of chain
    ``c`` bit-identical to :func:`glm_potential_grad_cuda` on ``w[c]`` and
    the rows ``x[z m:(z + 1) m]`` alone.  The operands as there; raises when
    the rows do not split evenly, and on a failed build or launch.
    ``.launches`` counts calls, ``.chain_evals`` the chains and
    ``.shard_evals`` the (chain, shard) partials they evaluated."""
    shards = int(data_shards)
    nll, grad, chains = _launch("glm_potential_partials_cuda", x, y, w,
                                offset, scale, family, shards)
    glm_potential_partials_cuda.launches += 1
    glm_potential_partials_cuda.chain_evals += chains
    glm_potential_partials_cuda.shard_evals += chains * shards
    if w.dim() == 1:
        nll, grad = nll[0], grad[0]
    return nll.to(w.dtype), grad.to(w.dtype)


glm_potential_partials_cuda.launches = 0
glm_potential_partials_cuda.chain_evals = 0
glm_potential_partials_cuda.shard_evals = 0
