"""Batched MALA / random-walk Metropolis proposal over a (C, D) ensemble.

    z' = z - eps * m_inv * grad + sqrt(2 * eps * m_inv) * noise

with one shared ``(D,)`` diagonal preconditioner ``m_inv``, a scalar step
``eps`` and standard normal ``noise`` drawn by the caller.  ``grad=None``
drops the drift term (the symmetric random-walk proposal); the gradient
operand is then left out, not zero-filled.

``ops.mala_step`` takes :func:`mala_step_ref` for tensors on the CPU and
:func:`mala_step_cuda` (``csrc/mala_step.cu``) for tensors on a card; it
never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .leapfrog import check_ensemble, host_scalar

_DTYPES = {torch.float32: "mala_step_f32", torch.float64: "mala_step_f64"}


def mala_step_ref(z, grad, noise, m_inv, eps):
    """The plain PyTorch version, in ``promote(dtype, float32)`` like the
    TPU kernel: ``sig = sqrt(2 * eps * m_inv)``, ``out = z + sig * noise``,
    then ``out - eps * m_inv * grad`` when ``grad`` is given."""
    out_dtype = z.dtype
    cd = torch.promote_types(out_dtype, torch.float32)
    if not isinstance(eps, torch.Tensor):
        eps = float(eps)  # a numpy scalar would turn the product into numpy
    z, noise, m_inv = (t.to(cd) for t in (z, noise, m_inv))
    sig = torch.sqrt(2.0 * eps * m_inv)
    out = z + sig * noise
    if grad is not None:
        out = out - eps * m_inv * grad.to(cd)
    return out.to(out_dtype)


def mala_step_cuda(z, grad, noise, m_inv, eps):
    """Launch ``csrc/mala_step.cu`` on the current stream: one thread per
    element of the (C, D) ensemble, ``eps`` a host number passed by value,
    ``grad=None`` the random walk (the kernel then reads three arrays, not
    four).  Raises on a wrong device, dtype, shape or layout, and on a
    failed build or launch."""
    name = "mala_step_cuda"
    operands = {"noise": noise, "m_inv": m_inv}
    if grad is not None:
        operands["grad"] = grad
    check_ensemble(name, _DTYPES, z, **operands)
    eps = host_scalar(eps, "eps", name)
    fn = getattr(_build.load("mala_step"), _DTYPES[z.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_double] \
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty_like(z)
    rows, cols = z.shape
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), None if grad is None else grad.data_ptr(),
                noise.data_ptr(), m_inv.data_ptr(), out.data_ptr(), eps,
                rows, cols, stream)
    if rc != 0:
        raise RuntimeError(f"mala_step kernel launch failed: cudaError {rc}")
    mala_step_cuda.launches += 1
    if grad is None:
        mala_step_cuda.launches_without_grad += 1
    return out


mala_step_cuda.launches = 0
# of those, the random walk's (the variant that reads no gradient)
mala_step_cuda.launches_without_grad = 0
