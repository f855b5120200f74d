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
- :class:`EnumContract` is the ``torch.autograd.Function`` that NUTS
  differentiates: tensors on the CPU take the plain versions, tensors on a
  card the kernels, and a failed build or launch raises.
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


def _fn(table, dtype, nargs):
    fn = getattr(_build.load("enum_contract"), table[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * nargs
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = _fn(_FWD, compute, 3)(alpha.data_ptr(), mat.data_ptr(),
                                       out.data_ptr(), rows, ki, k, stream)
        if rc != 0:
            raise RuntimeError(f"enum_contract kernel launch failed: "
                               f"cudaError {rc}")
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
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = _fn(_BWD, dtype, 6)(
                alpha.data_ptr(), mat.data_ptr(), out.data_ptr(),
                grad_out.data_ptr(), d_alpha.data_ptr(), d_mat.data_ptr(),
                rows, ki, k, stream)
        if rc != 0:
            raise RuntimeError(f"enum_contract_bwd kernel launch failed: "
                               f"cudaError {rc}")
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
