"""Logsumexp contraction for discrete-latent chain elimination.

``enum_contract(log_alpha, log_mat)`` computes ``out[..., j] =
logsumexp_i(log_alpha[..., i] + log_mat[..., i, j])`` over ``(..., Ki) x
(..., Ki, K) -> (..., K)``: one step of the forward algorithm that
``repro_torch.core.infer.enum.markov`` runs T-1 times per potential
evaluation.

- :func:`enum_contract_ref` is the plain PyTorch version, op for op the JAX
  package's ``repro.kernels.ref.enum_contract`` (max, sequential exp-sum,
  log, all ``-inf`` columns pinned to ``-inf``), computed in
  ``promote(dtype, float32)`` like the Pallas kernel.
- :func:`enum_contract_bwd_ref` is its gradient: ``p = exp(alpha_i + M_ij -
  out_j)`` (0 where ``out_j = -inf``), ``dM = g_j p``, ``dalpha = sum_j dM``.
- :func:`enum_contract_cuda` and :func:`enum_contract_bwd_cuda` launch the
  hand-written kernels of ``csrc/enum_contract.cu``; the forward is
  bit-identical to the plain version on the card.
- :class:`EnumContract` is its ``torch.autograd.Function``: tensors on the
  CPU take the plain versions, tensors on a card the kernels, and a failed
  build or launch raises.

``enum_chain(alpha0, mats)`` runs a whole chain of these steps,
``alpha_{t+1} = enum_contract(alpha_t, mats[t])`` for the T-1 matrices of
``mats (T-1, ..., K, K)``, and returns ``alpha_T``: the elimination
``markov`` runs per potential evaluation, the JAX package's ``lax.scan``
of ``enum_contract``.

- :func:`enum_chain_ref` is the plain chain, a loop of
  :func:`enum_contract_ref` that keeps every alpha, ``(T, ..., K)``;
  :func:`enum_chain_bwd_ref` the reverse loop of
  :func:`enum_contract_bwd_ref` from those alphas.
- :func:`enum_chain_cuda` and :func:`enum_chain_bwd_cuda` launch the chain
  kernels of ``csrc/enum_contract.cu``, one launch for all T-1 steps each;
  the forward is bit-identical to the plain chain on the card, the backward
  to T-1 launches of the one-step backward kernel.
- :class:`EnumChain` is the ``torch.autograd.Function`` that NUTS
  differentiates: one node per chain, routed by device as
  :class:`EnumContract` is, saving the stacked alphas for its backward.

``enum_chain_sample(alphas, mats, gumbel)`` is the backward half of
``markov``'s forward-filter/backward-sample: from the chain's alphas it
draws the states from last to first, each by the Gumbel-max trick on the
alphas plus the column of the next state.

- :func:`enum_chain_sample_ref` is the plain version, the JAX package's
  reverse ``lax.scan`` of ``random.categorical`` with its noise given.
- :func:`enum_chain_sample_cuda` launches ``chain_sample_kernel`` of
  ``csrc/enum_contract.cu``, one launch for the T steps, bit-identical to
  the plain version on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_FWD = {torch.float32: "enum_contract_fwd_f32",
        torch.float64: "enum_contract_fwd_f64"}
_BWD = {torch.float32: "enum_contract_bwd_f32",
        torch.float64: "enum_contract_bwd_f64"}
_CHAIN_FWD = {torch.float32: "enum_chain_fwd_f32",
              torch.float64: "enum_chain_fwd_f64"}
_CHAIN_BWD = {torch.float32: "enum_chain_bwd_f32",
              torch.float64: "enum_chain_bwd_f64"}
_CHAIN_SAMPLE = {torch.float32: "enum_chain_sample_f32",
                 torch.float64: "enum_chain_sample_f64"}
# the chain kernels' widest state (kMaxCols x 1024 columns of a CTA)
_CHAIN_MAX_K = 4096


def _batch_shape(log_alpha, log_mat):
    """``(batch, Ki, K)`` after broadcasting the leading dims."""
    if log_mat.dim() < 2 or log_alpha.dim() < 1:
        raise ValueError(
            f"enum_contract takes (..., Ki) and (..., Ki, K), got "
            f"{tuple(log_alpha.shape)} and {tuple(log_mat.shape)}")
    ki, k = log_mat.shape[-2:]
    if log_alpha.shape[-1] != ki:
        raise ValueError(
            f"enum_contract: log_alpha has {log_alpha.shape[-1]} states, "
            f"log_mat contracts over {ki}")
    if ki == 0:
        raise ValueError("enum_contract needs at least one state to contract")
    batch_a, batch_m = tuple(log_alpha.shape[:-1]), tuple(log_mat.shape[:-2])
    batch = batch_a if batch_a == batch_m \
        else tuple(torch.broadcast_shapes(batch_a, batch_m))
    return batch, ki, k


def _dtypes(log_alpha, log_mat):
    """(output dtype, compute dtype = promote(output, float32))."""
    out = torch.promote_types(log_alpha.dtype, log_mat.dtype)
    return out, torch.promote_types(out, torch.float32)


def enum_contract_ref(log_alpha, log_mat):
    """The plain PyTorch version, written as ``ref.enum_contract``."""
    out_dtype, compute = _dtypes(log_alpha, log_mat)
    x = log_alpha.to(compute)[..., :, None] + log_mat.to(compute)
    m = torch.amax(x, dim=-2)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    e = torch.exp(x - m_safe[..., None, :])
    # left-to-right sequential sum: the pinned order the kernel keeps
    s = e[..., 0, :]
    for i in range(1, e.shape[-2]):
        s = s + e[..., i, :]
    out = torch.where(finite, torch.log(s) + m_safe,
                      torch.full_like(m, -math.inf))
    return out.to(out_dtype)


def enum_contract_bwd_ref(alpha, mat, out, grad_out):
    """Gradient of :func:`enum_contract_ref` (the one ``jax.grad`` of the
    reference gives), with exact zeros for all ``-inf`` columns and rows:
    ``(..., Ki) x (..., Ki, K) x (..., K) x (..., K) -> (dalpha, dmat)``."""
    masked = torch.isneginf(out)[..., None, :]
    out_safe = torch.where(masked, torch.zeros_like(mat[..., :1, :]),
                           out[..., None, :])
    p = torch.exp(alpha[..., :, None] + mat - out_safe)
    p = torch.where(masked, torch.zeros_like(p), p)
    d_mat = grad_out[..., None, :] * p
    return d_mat.sum(-1), d_mat


def _launch(what, table, dtype, device, *args):
    """Call ``table[dtype]`` of the built library on the current stream:
    ``args`` are tensors (passed as pointers) then ``(rows, int, int)``;
    raises unless the launch succeeded."""
    tensors, sizes = args[:-3], args[-3:]
    fn = getattr(_build.load("enum_contract"), table[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*(t.data_ptr() for t in tensors), *sizes, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _check_cuda(name, tensors, dtype):
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {device}")
    if dtype not in _FWD:
        raise TypeError(f"{name} computes in float32/float64, got {dtype}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors lie on {t.device} and {device}")
    return device


def enum_contract_cuda(log_alpha, log_mat):
    """Launch the forward kernel on the current stream.  Inputs broadcast
    over their leading dims; other float types are computed in float32 and
    cast back, as the Pallas kernel does.  Raises on a wrong device, shape
    or dtype, and on a failed build or launch."""
    batch, ki, k = _batch_shape(log_alpha, log_mat)
    out_dtype, compute = _dtypes(log_alpha, log_mat)
    device = _check_cuda("enum_contract_cuda", (log_alpha, log_mat), compute)
    alpha = log_alpha.to(compute).broadcast_to(batch + (ki,)).contiguous()
    mat = log_mat.to(compute).broadcast_to(batch + (ki, k)).contiguous()
    out = torch.empty(batch + (k,), dtype=compute, device=device)
    rows = math.prod(batch)
    if rows and k:
        _launch("enum_contract", _FWD, compute, device, alpha, mat, out,
                rows, ki, k)
        enum_contract_cuda.launches += 1
    return out.to(out_dtype)


enum_contract_cuda.launches = 0


def enum_contract_bwd_cuda(alpha, mat, out, grad_out):
    """Launch the backward kernel: ``alpha (..., Ki)``, ``mat (..., Ki,
    K)``, ``out`` and ``grad_out (..., K)`` with the same leading dims, in
    float32 or float64 -> ``(dalpha, dmat)``."""
    batch, ki, k = _batch_shape(alpha, mat)
    dtype = alpha.dtype
    device = _check_cuda("enum_contract_bwd_cuda",
                         (alpha, mat, out, grad_out), dtype)
    shapes = ((alpha, batch + (ki,)), (mat, batch + (ki, k)),
              (out, batch + (k,)), (grad_out, batch + (k,)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"enum_contract_bwd_cuda: got {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
    alpha, mat, out, grad_out = (t.contiguous() for t, _ in shapes)
    d_alpha = torch.empty_like(alpha)
    d_mat = torch.empty_like(mat)
    rows = math.prod(batch)
    if rows:
        _launch("enum_contract_bwd", _BWD, dtype, device, alpha, mat, out,
                grad_out, d_alpha, d_mat, rows, ki, k)
        enum_contract_bwd_cuda.launches += 1
    return d_alpha, d_mat


enum_contract_bwd_cuda.launches = 0


def _sum_to(grad, shape):
    """Reduce a gradient of the broadcast shape back to ``shape``."""
    lead = grad.dim() - len(shape)
    if lead:
        grad = grad.sum(tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape)
                 if s == 1 and grad.shape[i] != 1)
    return grad.sum(dims, keepdim=True) if dims else grad


class EnumContract(torch.autograd.Function):
    """``enum_contract`` with its gradient.  Forward and backward go to the
    plain versions for CPU tensors and to the kernels for CUDA tensors; no
    path falls back from a kernel to a plain version."""

    @staticmethod
    def forward(ctx, log_alpha, log_mat):
        batch, ki, k = _batch_shape(log_alpha, log_mat)
        out_dtype, compute = _dtypes(log_alpha, log_mat)
        alpha = log_alpha.to(compute).broadcast_to(batch + (ki,))
        mat = log_mat.to(compute).broadcast_to(batch + (ki, k))
        if alpha.device.type == "cpu":
            out = enum_contract_ref(alpha, mat)
        else:
            alpha, mat = alpha.contiguous(), mat.contiguous()
            out = enum_contract_cuda(alpha, mat)
        ctx.save_for_backward(alpha, mat, out)
        ctx.inputs = ((tuple(log_alpha.shape), log_alpha.dtype),
                      (tuple(log_mat.shape), log_mat.dtype))
        return out.to(out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        alpha, mat, out = ctx.saved_tensors
        g = grad_out.to(out.dtype).broadcast_to(out.shape)
        if alpha.device.type == "cpu":
            d_alpha, d_mat = enum_contract_bwd_ref(alpha, mat, out, g)
        else:
            d_alpha, d_mat = enum_contract_bwd_cuda(alpha, mat, out, g)
        (a_shape, a_dtype), (m_shape, m_dtype) = ctx.inputs
        return (_sum_to(d_alpha, a_shape).to(a_dtype),
                _sum_to(d_mat, m_shape).to(m_dtype))


# --- the chain: T-1 contractions in one launch -------------------------------

def _chain_inputs(alpha0, mats):
    """``alpha0 (..., K)`` and ``mats (T-1, ..., K, K)`` in the compute dtype
    (:func:`_dtypes`), broadcast to the chain's batch -> ``(alpha0, mats,
    output dtype)``."""
    if mats.dim() < 3 or alpha0.dim() < 1:
        raise ValueError(
            f"enum_chain takes (..., K) and (T-1, ..., K, K), got "
            f"{tuple(alpha0.shape)} and {tuple(mats.shape)}")
    k = mats.shape[-1]
    if mats.shape[-2] != k or alpha0.shape[-1] != k:
        raise ValueError(
            f"enum_chain: every step is a square (K, K) matrix over "
            f"alpha0's K states, got {tuple(alpha0.shape)} and "
            f"{tuple(mats.shape)}")
    if k == 0:
        raise ValueError("enum_chain needs at least one state to contract")
    batch_a, batch_m = tuple(alpha0.shape[:-1]), tuple(mats.shape[1:-2])
    batch = batch_a if batch_a == batch_m \
        else tuple(torch.broadcast_shapes(batch_a, batch_m))
    out_dtype, compute = _dtypes(alpha0, mats)
    # each step's matrix broadcasts against alpha0 as enum_contract's does
    lift = (1,) * (len(batch) - len(batch_m))
    mats = mats.reshape(mats.shape[:1] + lift + mats.shape[1:])
    return (alpha0.to(compute).broadcast_to(batch + (k,)),
            mats.to(compute).broadcast_to(mats.shape[:1] + batch + (k, k)),
            out_dtype)


def enum_chain_ref(alpha0, mats):
    """The plain chain: ``alphas (T, ..., K)`` in the compute dtype, with
    ``alphas[0] = alpha0`` and ``alphas[t + 1] =
    enum_contract_ref(alphas[t], mats[t])``."""
    alpha, mats, _ = _chain_inputs(alpha0, mats)
    alphas = [alpha]
    for mat in mats.unbind(0):
        alphas.append(enum_contract_ref(alphas[-1], mat))
    return torch.stack(alphas)


def enum_chain_bwd_ref(mats, alphas, grad_out):
    """Gradient of :func:`enum_chain_ref` from its alphas: ``mats (T-1, ...,
    K, K)``, ``alphas (T, ..., K)`` and the gradient ``grad_out (..., K)`` of
    ``alphas[-1]`` -> ``(d_alpha0, d_mats)``, through
    :func:`enum_contract_bwd_ref` from step T-1 down to 1."""
    g, d_mats = grad_out, []
    for t in range(mats.shape[0] - 1, -1, -1):
        g, d_mat = enum_contract_bwd_ref(alphas[t], mats[t], alphas[t + 1], g)
        d_mats.append(d_mat)
    return g, torch.stack(d_mats[::-1]) if d_mats else torch.zeros_like(mats)


def enum_chain_cuda(alpha0, mats):
    """Launch the chain forward on the current stream: ``alpha0 (..., K)``
    and ``mats (T-1, ..., K, K)`` -> ``alphas (T, ..., K)`` in the compute
    dtype, as :func:`enum_chain_ref`; one launch for the T-1 steps, none for
    T = 1.  Raises on a wrong device, shape or dtype, on K > 4096, and on a
    failed build or launch."""
    alpha, mats, _ = _chain_inputs(alpha0, mats)
    device = _check_cuda("enum_chain_cuda", (alpha, mats), alpha.dtype)
    steps, k = mats.shape[0], alpha.shape[-1]
    if k > _CHAIN_MAX_K:
        raise ValueError(f"enum_chain_cuda takes at most {_CHAIN_MAX_K} "
                         f"states, got {k}")
    alpha, mats = alpha.contiguous(), mats.contiguous()
    alphas = torch.empty((steps + 1,) + tuple(alpha.shape), dtype=alpha.dtype,
                         device=device)
    rows = math.prod(alpha.shape[:-1])
    if steps and rows:
        _launch("enum_chain", _CHAIN_FWD, alpha.dtype, device, alpha, mats,
                alphas, rows, steps, k)
        enum_chain_cuda.launches += 1
    else:
        alphas[0] = alpha
    return alphas


enum_chain_cuda.launches = 0


def enum_chain_bwd_cuda(mats, alphas, grad_out):
    """Launch the chain backward: ``mats (T-1, ..., K, K)``, the forward's
    ``alphas (T, ..., K)`` and ``grad_out (..., K)``, one float32 or float64
    dtype -> ``(d_alpha0, d_mats)``; one launch for the T-1 steps, none for
    T = 1."""
    dtype, k = alphas.dtype, alphas.shape[-1]
    device = _check_cuda("enum_chain_bwd_cuda", (mats, alphas, grad_out),
                         dtype)
    steps, batch = mats.shape[0], tuple(alphas.shape[1:-1])
    shapes = ((mats, (steps,) + batch + (k, k)),
              (alphas, (steps + 1,) + batch + (k,)),
              (grad_out, batch + (k,)))
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"enum_chain_bwd_cuda: got {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")
    if k > _CHAIN_MAX_K:
        raise ValueError(f"enum_chain_bwd_cuda takes at most {_CHAIN_MAX_K} "
                         f"states, got {k}")
    mats, alphas, grad_out = (t.contiguous() for t, _ in shapes)
    d_mats = torch.empty_like(mats)
    rows = math.prod(batch)
    if not steps:
        return grad_out.clone(), d_mats
    d_alpha0 = torch.empty_like(grad_out)
    if rows:
        _launch("enum_chain_bwd", _CHAIN_BWD, dtype, device, mats, alphas,
                grad_out, d_alpha0, d_mats, rows, steps, k)
        enum_chain_bwd_cuda.launches += 1
    return d_alpha0, d_mats


enum_chain_bwd_cuda.launches = 0


class EnumChain(torch.autograd.Function):
    """``enum_chain`` with its gradient: one autograd node per chain and, on
    a card, one forward and one backward launch.  CPU tensors take the plain
    chain, which gives bit for bit the values and gradients of a loop of
    :class:`EnumContract` calls; no path falls back from a kernel to a plain
    version.  Inputs of a lower float type are computed in float32 along the
    whole chain and rounded once at its end."""

    @staticmethod
    def forward(ctx, alpha0, mats):
        alpha, m, out_dtype = _chain_inputs(alpha0, mats)
        if alpha.device.type == "cpu":
            alphas = enum_chain_ref(alpha, m)
        else:
            m = m.contiguous()
            alphas = enum_chain_cuda(alpha, m)
        ctx.save_for_backward(m, alphas)
        ctx.inputs = ((tuple(alpha0.shape), alpha0.dtype),
                      (tuple(mats.shape), mats.dtype))
        return alphas[-1].to(out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        mats, alphas = ctx.saved_tensors
        g = grad_out.to(alphas.dtype).broadcast_to(alphas.shape[1:])
        if alphas.device.type == "cpu":
            d_alpha0, d_mats = enum_chain_bwd_ref(mats, alphas, g)
        else:
            d_alpha0, d_mats = enum_chain_bwd_cuda(mats, alphas, g)
        (a_shape, a_dtype), (m_shape, m_dtype) = ctx.inputs
        # the step axis of d_mats stays: each step's gradient is summed to
        # the shape of mats[t]
        d_mats = _sum_to(d_mats.movedim(0, -1), m_shape[1:] + m_shape[:1])
        return (_sum_to(d_alpha0, a_shape).to(a_dtype),
                d_mats.movedim(-1, 0).to(m_dtype))


# --- the chain's backward sample ---------------------------------------------

def _sample_inputs(alphas, mats, gumbel):
    """Check ``alphas (T, ..., K)``, ``mats (T-1, ..., K, K)`` and ``gumbel
    (T, ..., K)``: one float dtype and one batch shape."""
    if alphas.dim() < 2:
        raise ValueError(f"enum_chain_sample takes alphas (T, ..., K), got "
                         f"{tuple(alphas.shape)}")
    steps, k = alphas.shape[0] - 1, alphas.shape[-1]
    want = (steps,) + tuple(alphas.shape[1:]) + (k,)
    if tuple(mats.shape) != want or gumbel.shape != alphas.shape:
        raise ValueError(
            f"enum_chain_sample takes alphas (T, ..., K), mats (T-1, ..., K, "
            f"K) and gumbel (T, ..., K), got {tuple(alphas.shape)}, "
            f"{tuple(mats.shape)} and {tuple(gumbel.shape)}")
    if k == 0 or steps < 0:
        raise ValueError("enum_chain_sample needs at least one state and step")
    if not (alphas.dtype == mats.dtype == gumbel.dtype) \
            or not alphas.is_floating_point():
        raise TypeError(f"enum_chain_sample takes one float dtype, got "
                        f"{alphas.dtype}, {mats.dtype}, {gumbel.dtype}")
    return steps, k


def enum_chain_sample_ref(alphas, mats, gumbel):
    """The plain backward sample -> ``idx (T, ...)`` int64: ``idx[T-1] =
    argmax(gumbel[T-1] + alphas[T-1])`` and, from ``t = T-2`` down to 0,
    ``idx[t] = argmax(gumbel[t] + (alphas[t] + mats[t][..., :,
    idx[t+1]]))``, the JAX package's order of additions; a tie goes to the
    lowest index (``torch.argmax``)."""
    steps, k = _sample_inputs(alphas, mats, gumbel)
    z = torch.argmax(gumbel[-1] + alphas[-1], dim=-1)
    out = [z]
    for t in range(steps - 1, -1, -1):
        index = z[..., None, None].expand(tuple(mats.shape[1:-1]) + (1,))
        column = torch.gather(mats[t], -1, index).squeeze(-1)
        z = torch.argmax(gumbel[t] + (alphas[t] + column), dim=-1)
        out.append(z)
    return torch.stack(out[::-1])


def enum_chain_sample_cuda(alphas, mats, gumbel):
    """Launch the backward sample on the current stream: ``alphas (T, ...,
    K)``, ``mats (T-1, ..., K, K)`` and ``gumbel (T, ..., K)`` in float32 or
    float64 -> ``idx (T, ...)`` int64, as :func:`enum_chain_sample_ref`; one
    launch for the T steps.  Raises on a wrong device, shape or dtype, and
    on a failed build or launch."""
    steps, k = _sample_inputs(alphas, mats, gumbel)
    device = _check_cuda("enum_chain_sample_cuda", (alphas, mats, gumbel),
                         alphas.dtype)
    alphas, mats, gumbel = (t.contiguous() for t in (alphas, mats, gumbel))
    idx = torch.empty(alphas.shape[:-1], dtype=torch.int64, device=device)
    rows = math.prod(alphas.shape[1:-1])
    if rows:
        _launch("enum_chain_sample", _CHAIN_SAMPLE, alphas.dtype, device,
                alphas, mats, gumbel, idx, rows, steps, k)
        enum_chain_sample_cuda.launches += 1
    return idx


enum_chain_sample_cuda.launches = 0
