"""RMSNorm ``x * rsqrt(mean(x**2, -1) + eps) * w`` over the last axis, with
float32 statistics and a float32 weight, the result in x's dtype, and its
gradient.

- :func:`rmsnorm_ref` / :func:`rmsnorm_cuda`: the forward, plain and
  ``csrc/rmsnorm.cu``.
- :func:`rmsnorm_bwd_ref` / :func:`rmsnorm_bwd_cuda`: the backward (the TPU
  kernel's ``_bwd``), ``dx = r (g w) - xhat r mean(g w xhat)`` and ``dw =
  sum_rows g xhat``, rstd ``r`` recomputed from the saved ``x``.
- :class:`RMSNorm`: the ``torch.autograd.Function`` that ties them; it
  saves ``(x, w)`` and runs the forward and backward it is handed.

``ops.rmsnorm`` hands it the plain versions for tensors on the CPU and the
kernels for tensors on a card; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "rmsnorm_fwd_f32",
           torch.bfloat16: "rmsnorm_fwd_bf16"}
_BWD = {torch.float32: "rmsnorm_bwd_f32", torch.bfloat16: "rmsnorm_bwd_bf16"}
_ROWS_PER_BLOCK = 8  # csrc/rmsnorm.cu: WARPS, the rows of one dw partial


def rmsnorm_ref(x, weight, eps=1e-6):
    """The plain PyTorch version (``repro/kernels/ref.py:rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, weight, g, eps=1e-6):
    """The plain backward (``repro/kernels/rmsnorm.py:_bwd_kernel`` over
    all rows at once): ``(dx in x's dtype, dw float32 (d,))``."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    gf = g.reshape(-1, d).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = xf * r
    gw = gf * weight.float()
    dx = r * gw - xhat * r * torch.mean(gw * xhat, dim=-1, keepdim=True)
    return dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(0)


def _check(name, x, weight, extra=()):
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} supports float32/bfloat16, got {x.dtype}")
    d = x.shape[-1]
    if weight.device != x.device or weight.dtype != torch.float32 \
            or tuple(weight.shape) != (d,):
        raise ValueError(f"{name}: weight is {weight.dtype} "
                         f"{tuple(weight.shape)} on {weight.device}; expected "
                         f"float32 ({d},) on {x.device}")
    for label, t in extra:
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name}: {label} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not all(t.is_contiguous() for t in (x, weight, *(t for _, t in extra))):
        raise ValueError(f"{name} needs contiguous tensors")
    return d


def rmsnorm_cuda(x, weight, eps=1e-6):
    """Launch ``csrc/rmsnorm.cu`` on the current stream: one warp per row of
    ``x.reshape(-1, d)``.  ``x`` is a contiguous float32 or bfloat16 CUDA
    tensor, ``weight`` a contiguous float32 ``(d,)`` on the same card.
    Raises on anything else and on a failed build or launch."""
    d = _check("rmsnorm_cuda", x, weight)
    fn = getattr(_build.load("rmsnorm"), _DTYPES[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {rc}")
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


def rmsnorm_bwd_cuda(x, weight, g, eps=1e-6):
    """Launch the backward of ``csrc/rmsnorm.cu`` on the current stream:
    ``g`` is the gradient of the output, of x's dtype and shape, all
    contiguous on one card.  Returns ``(dx, dw float32 (d,))``; the per-block
    ``dw`` partials are summed on the card in a fixed order.  Raises on
    anything else and on a failed build or launch."""
    d = _check("rmsnorm_bwd_cuda", x, weight, (("g", g),))
    fn = getattr(_build.load("rmsnorm"), _BWD[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_float,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    blocks = -(-rows // _ROWS_PER_BLOCK)
    dw_part = torch.empty((max(blocks, 1), d), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), weight.data_ptr(), g.data_ptr(), dx.data_ptr(),
                dw_part.data_ptr(), dw.data_ptr(), rows, d, float(eps),
                stream)
    if rc != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: cudaError {rc}")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dw


rmsnorm_bwd_cuda.launches = 0


class RMSNorm(torch.autograd.Function):
    """RMSNorm with its gradient: ``apply(x, weight, eps, fwd, bwd)`` runs
    ``fwd(x, weight, eps)`` and, in the backward, ``bwd(x, weight, g,
    eps)`` (``ops.rmsnorm`` picks kernels or plain versions by device).
    Saves ``(x, weight)`` and recomputes rstd, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, weight, eps, fwd, bwd):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bwd = eps, bwd
        return fwd(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = ctx.bwd(x, weight, g.contiguous(), ctx.eps)
        return dx, dw.to(weight.dtype), None, None, None
