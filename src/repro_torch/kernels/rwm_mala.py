"""Batched MALA / random-walk Metropolis proposal over a (C, D) ensemble.

    z' = z - eps * m_inv * grad + sqrt(2 * eps * m_inv) * noise

with one shared ``(D,)`` diagonal preconditioner ``m_inv``, a scalar step
``eps`` and standard normal ``noise`` drawn by the caller.  ``grad=None``
drops the drift term (the symmetric random-walk proposal); the gradient
operand is then left out, not zero-filled.

After the potential at the proposal, ``mala_accept`` runs the
Metropolis-Hastings step of every chain in one launch: MALA's proposal
densities, the accept test, the selection of ``z``, ``pe`` (and MALA's
``grad``), and the iteration's bookkeeping (the running mean accept
probability after warmup, the chains' harmonic-mean accept probability in
warmup).

``ops.mala_step`` and ``ops.mala_accept`` take the plain versions for
tensors on the CPU and the CUDA kernels (``csrc/mala_step.cu``) for tensors
on a card; they never fall back from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .leapfrog import (check_ensemble, fold_ticket, harmonic_mean_accept,
                       host_scalar)

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


def mala_accept_ref(z, pe, grad, z_new, pe_new, grad_new, noise, m_inv, u,
                    eps, coef, mean_accept_prob, n_post):
    """The plain version of the accept step over a (C, D) ensemble.

    ``grad``/``grad_new``/``noise`` are MALA's (all ``None`` for RWM: no
    proposal densities, the gradient left to the caller); ``eps`` and
    ``coef`` (``float32(-0.25) / eps``) are host numbers; ``u`` the (C,)
    accept uniforms.  ``n_post > 0`` is the post-warmup draw count for the
    running mean; ``n_post == 0`` is warmup.  Returns ``(z, pe, grad,
    accept_prob, diverging, mean_accept_prob, hmean)``: in warmup the mean
    is ``accept_prob`` itself and ``hmean`` the harmonic mean, after it
    ``hmean`` is ``None``."""
    log_accept = pe - pe_new
    if grad_new is not None:
        # xi_rev = (z - z' + eps * minv * grad') / sqrt(2 * eps * minv)
        logq_fwd = -0.5 * torch.sum(noise * noise, -1)
        diff = z - z_new + eps * m_inv * grad_new
        logq_rev = coef * torch.sum(diff * diff / m_inv, -1)
        log_accept = log_accept + logq_rev - logq_fwd
    diverging = ~torch.isfinite(pe_new)
    log_accept = torch.where(diverging, -math.inf, log_accept)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    accept = u < accept_prob
    acc2 = accept[:, None]
    z = torch.where(acc2, z_new, z)
    pe = torch.where(accept, pe_new, pe)
    if grad is not None:
        grad = torch.where(acc2, grad_new, grad)
    if n_post > 0:
        mean_ap = mean_accept_prob \
            + (accept_prob - mean_accept_prob) / n_post
        return z, pe, grad, accept_prob, diverging, mean_ap, None
    return (z, pe, grad, accept_prob, diverging, accept_prob,
            harmonic_mean_accept(accept_prob))


def mala_accept_scale(z, pe, grad, z_new, pe_new, grad_new, noise, m_inv, u,
                      eps, coef, *_):
    """Each chain's sum of the magnitudes of the terms its log_accept adds
    up (|pe|, a finite |pe'|, and MALA's two sums of non-negative terms), in
    float64: kernel and plain version sum them in another order, so
    log_accept may move by a relative tolerance of this, accept_prob by
    expm1 of that of itself."""
    scale = pe.double().abs() + pe_new.double().abs().nan_to_num(
        nan=0.0, posinf=0.0)
    if grad_new is not None:
        diff = (z - z_new).double() + eps * (m_inv * grad_new).double()
        scale = scale + 0.5 * (noise.double() ** 2).sum(-1) \
            + abs(coef) * (diff * diff / m_inv.double()).sum(-1)
    return scale


_ACCEPT = {torch.float32: "mala_accept_f32", torch.float64: "mala_accept_f64"}


def _accept_lib():
    lib = _build.load("mala_step")
    if lib.mala_accept_f32.argtypes is None:
        for fn in (lib.mala_accept_f32, lib.mala_accept_f64):
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_double] * 2 \
                + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 9
            fn.restype = ctypes.c_int
        lib.mala_accept_max_chains.restype = ctypes.c_int
    return lib


def mala_accept_cuda(z, pe, grad, z_new, pe_new, grad_new, noise, m_inv, u,
                     eps, coef, mean_accept_prob, n_post):
    """Launch ``mala_accept`` (``csrc/mala_step.cu``) once on the current
    stream: one CTA per chain; the arguments and results are
    :func:`mala_accept_ref`'s.  Selected rows, the running mean and the
    harmonic mean are bit-identical to the plain version's on the card for
    the same ``accept_prob``; MALA's two sums are taken in another order.
    Raises on a wrong device, dtype, shape or layout, on more chains than
    the kernel folds, and on a failed build or launch."""
    name = "mala_accept_cuda"
    has_grad = grad is not None
    if (grad_new is not None) != has_grad or (noise is not None) != has_grad:
        raise ValueError(f"{name}: grad, grad_new and noise are given "
                         "together (MALA) or not at all (RWM)")
    operands = {"z_new": z_new, "m_inv": m_inv}
    if has_grad:
        operands.update(grad=grad, grad_new=grad_new, noise=noise)
    check_ensemble(name, _ACCEPT, z, **operands)
    rows, cols = z.shape
    n_post = int(n_post)
    per_chain = {"pe": pe, "pe_new": pe_new, "u": u}
    if n_post > 0:
        per_chain["mean_accept_prob"] = mean_accept_prob
    elif n_post < 0:
        raise ValueError(f"{name}: n_post must be >= 0, got {n_post}")
    for key, t in per_chain.items():
        if (t.device != z.device or t.dtype != z.dtype
                or tuple(t.shape) != (rows,) or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} is {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}; expected contiguous {z.dtype} "
                             f"({rows},) on {z.device}")
    lib = _accept_lib()
    if rows > lib.mala_accept_max_chains():
        raise ValueError(f"{name}: {rows} chains, at most "
                         f"{lib.mala_accept_max_chains()}")
    eps = host_scalar(eps, "eps", name)
    coef = host_scalar(coef, "coef", name)
    z_out = torch.empty_like(z)
    pe_out, accept_prob = torch.empty_like(pe), torch.empty_like(pe)
    g_out = torch.empty_like(z) if has_grad else None
    diverging = torch.empty(rows, dtype=torch.bool, device=z.device)
    mean_out = torch.empty_like(pe) if n_post > 0 else None
    hmean = None if n_post > 0 else torch.empty((), dtype=z.dtype,
                                                device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    ticket = None if n_post > 0 else fold_ticket(z.device, stream)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(z.device):
        rc = getattr(lib, _ACCEPT[z.dtype])(
            z.data_ptr(), pe.data_ptr(), ptr(grad), z_new.data_ptr(),
            pe_new.data_ptr(), ptr(grad_new), ptr(noise), m_inv.data_ptr(),
            u.data_ptr(), ptr(mean_accept_prob if n_post > 0 else None), eps,
            coef, n_post, rows, cols, z_out.data_ptr(), pe_out.data_ptr(),
            ptr(g_out), accept_prob.data_ptr(), diverging.data_ptr(),
            ptr(mean_out), ptr(hmean), ptr(ticket), stream)
    if rc != 0:
        raise RuntimeError(f"mala_accept kernel launch failed: cudaError "
                           f"{rc}")
    mala_accept_cuda.launches += 1
    if n_post > 0:
        return z_out, pe_out, g_out, accept_prob, diverging, mean_out, None
    return z_out, pe_out, g_out, accept_prob, diverging, accept_prob, hmean


mala_accept_cuda.launches = 0
