"""Fused leapfrog half-step for HMC/NUTS (diagonal mass).

One pass computes the momentum half-step and the position full-step:
``r' = r - (eps/2) * g`` and ``z' = z + eps * (r' * m_inv)``, where ``g``
is the gradient of the *potential* (the sign convention of
``hmc_util.velocity_verlet``).

``ops.leapfrog_halfstep`` takes the plain version for tensors on the CPU
and the CUDA kernel (``csrc/leapfrog.cu``) for tensors on a card; it never
falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "leapfrog_halfstep_f32",
           torch.float64: "leapfrog_halfstep_f64"}


def leapfrog_halfstep_ref(z, r, grad, m_inv, eps):
    """The plain PyTorch version: the same arithmetic as the kernel."""
    r_new = r - 0.5 * eps * grad
    return z + eps * (r_new * m_inv), r_new


def _fn(dtype):
    fn = getattr(_build.load("leapfrog"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def leapfrog_halfstep_cuda(z, r, grad, m_inv, eps):
    """Launch the CUDA kernel on the current stream.

    ``eps`` may be a Python number or a one-element tensor on the same
    device; as a tensor it is read by the kernel from device memory, so no
    value crosses to the host.  Raises on a wrong device, dtype, shape or
    layout, and on a failed build or launch.
    """
    if z.device.type != "cuda":
        raise ValueError(f"leapfrog_halfstep_cuda needs CUDA tensors, got "
                         f"{z.device}")
    if z.dtype not in _DTYPES:
        raise TypeError(f"leapfrog_halfstep_cuda supports float32/float64, "
                        f"got {z.dtype}")
    for name, t in (("r", r), ("grad", grad), ("m_inv", m_inv)):
        if t.device != z.device or t.dtype != z.dtype or t.shape != z.shape:
            raise ValueError(
                f"leapfrog_halfstep_cuda: {name} is {t.dtype} {tuple(t.shape)} "
                f"on {t.device}; expected {z.dtype} {tuple(z.shape)} on "
                f"{z.device}")
    if z.dim() != 1:
        raise ValueError(f"leapfrog_halfstep_cuda takes flat (D,) vectors, "
                         f"got shape {tuple(z.shape)}")
    if not all(t.is_contiguous() for t in (z, r, grad, m_inv)):
        raise ValueError("leapfrog_halfstep_cuda needs contiguous tensors")
    if isinstance(eps, torch.Tensor):
        if eps.device != z.device or eps.numel() != 1:
            raise ValueError("leapfrog_halfstep_cuda: eps must be one "
                             f"element on {z.device}")
        eps = eps.reshape(1).to(z.dtype).contiguous()
    else:
        eps = torch.full((1,), float(eps), dtype=z.dtype, device=z.device)
    z_out, r_out = torch.empty_like(z), torch.empty_like(r)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = _fn(z.dtype)(eps.data_ptr(), z.data_ptr(), r.data_ptr(),
                          grad.data_ptr(), m_inv.data_ptr(), z_out.data_ptr(),
                          r_out.data_ptr(), z.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"leapfrog_halfstep kernel launch failed: "
                           f"cudaError {rc}")
    leapfrog_halfstep_cuda.launches += 1
    return z_out, r_out


leapfrog_halfstep_cuda.launches = 0
