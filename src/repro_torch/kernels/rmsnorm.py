"""RMSNorm forward: ``x * rsqrt(mean(x**2, -1) + eps) * w`` over the last
axis, with float32 statistics and a float32 weight, the result in x's dtype.

``ops.rmsnorm`` takes :func:`rmsnorm_ref` for tensors on the CPU and
:func:`rmsnorm_cuda` (``csrc/rmsnorm.cu``) for tensors on a card; it never
falls back from one to the other.  The backward (the TPU kernel's ``_bwd``)
waits for the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "rmsnorm_fwd_f32",
           torch.bfloat16: "rmsnorm_fwd_bf16"}


def rmsnorm_ref(x, weight, eps=1e-6):
    """The plain PyTorch version (``repro/kernels/ref.py:rmsnorm``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_cuda(x, weight, eps=1e-6):
    """Launch ``csrc/rmsnorm.cu`` on the current stream: one warp per row of
    ``x.reshape(-1, d)``.  ``x`` is a contiguous float32 or bfloat16 CUDA
    tensor, ``weight`` a contiguous float32 ``(d,)`` on the same card.
    Raises on anything else and on a failed build or launch."""
    name = "rmsnorm_cuda"
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
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")
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
