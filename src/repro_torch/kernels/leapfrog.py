"""Fused leapfrog half-step for HMC/NUTS (diagonal mass).

One pass computes the momentum half-step and the position full-step:
``r' = r - (eps/2) * g`` and ``z' = z + eps * (r' * m_inv)``, where ``g``
is the gradient of the *potential* (the sign convention of
``hmc_util.velocity_verlet``).

The chain-batched form (``leapfrog_halfstep_batch``, the ChEES ensemble's
integrator) takes ``(C, D)`` positions, momenta and gradients with one
shared ``(D,)`` ``m_inv`` and a ``kick`` of 0.5 (a half-kick) or 1.0 (the
two half-kicks between interior steps merged):
``r' = r - (kick * eps) * g``, ``z' = z + eps * (r' * m_inv)``.

``ops.leapfrog_halfstep`` and ``ops.leapfrog_halfstep_batch`` take the
plain versions for tensors on the CPU and the CUDA kernels
(``csrc/leapfrog.cu``, ``csrc/leapfrog_batch.cu``) for tensors on a card;
they never fall back from one to the other.
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


_BATCH_DTYPES = {torch.float32: "leapfrog_halfstep_batch_f32",
                 torch.float64: "leapfrog_halfstep_batch_f64"}


def leapfrog_halfstep_batch_ref(z, r, grad, m_inv, eps, kick=0.5):
    """The plain PyTorch version of the batch op, in ``promote(dtype,
    float32)`` like the TPU kernel (float64 stays float64)."""
    z_dtype, r_dtype = z.dtype, r.dtype
    cd = torch.promote_types(z_dtype, torch.float32)
    if not isinstance(eps, torch.Tensor):
        eps = float(eps)  # a numpy scalar would turn the product into numpy
    kick = float(kick)
    z, r, grad, m_inv = (t.to(cd) for t in (z, r, grad, m_inv))
    r_new = r - (kick * eps) * grad
    return (z + eps * (r_new * m_inv)).to(z_dtype), r_new.to(r_dtype)


def host_scalar(value, name, kernel):
    """``value`` as a Python float for a kernel that takes it by value; a
    tensor on a card is refused (reading it would wait for the device)."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu" or value.numel() != 1:
            raise ValueError(f"{kernel}: {name} must be a host number (the "
                             f"kernel takes it by value), got a tensor of "
                             f"shape {tuple(value.shape)} on {value.device}")
    return float(value)


def check_ensemble(kernel, dtypes, z, **others):
    """Raise unless ``z`` is a contiguous (C, D) CUDA tensor of a supported
    dtype and every other operand (``m_inv`` a (D,) row) matches it."""
    if z.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {z.device}")
    if z.dtype not in dtypes:
        raise TypeError(f"{kernel} supports float32/float64, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"{kernel} takes a (C, D) ensemble, got shape "
                         f"{tuple(z.shape)}")
    for name, t in others.items():
        shape = z.shape[1:] if name == "m_inv" else z.shape
        if t.device != z.device or t.dtype != z.dtype or t.shape != shape:
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; expected {z.dtype} {tuple(shape)} on "
                f"{z.device}")
    if not all(t.is_contiguous() for t in (z, *others.values())):
        raise ValueError(f"{kernel} needs contiguous tensors")


def leapfrog_halfstep_batch_cuda(z, r, grad, m_inv, eps, kick=0.5):
    """Launch ``csrc/leapfrog_batch.cu`` on the current stream: one thread
    per element of the (C, D) ensemble.  ``eps`` and ``kick`` are host
    numbers passed by value.  Raises on a wrong device, dtype, shape or
    layout, on a ``kick`` other than 0.5 or 1.0, and on a failed build or
    launch."""
    name = "leapfrog_halfstep_batch_cuda"
    check_ensemble(name, _BATCH_DTYPES, z, r=r, grad=grad, m_inv=m_inv)
    eps = host_scalar(eps, "eps", name)
    kick = host_scalar(kick, "kick", name)
    if kick not in (0.5, 1.0):
        raise ValueError(f"{name}: kick must be 0.5 or 1.0, got {kick}")
    fn = getattr(_build.load("leapfrog_batch"), _BATCH_DTYPES[z.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_double] * 2 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    z_out, r_out = torch.empty_like(z), torch.empty_like(r)
    rows, cols = z.shape
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), r.data_ptr(), grad.data_ptr(), m_inv.data_ptr(),
                z_out.data_ptr(), r_out.data_ptr(), eps, kick, rows, cols,
                stream)
    if rc != 0:
        raise RuntimeError(f"leapfrog_halfstep_batch kernel launch failed: "
                           f"cudaError {rc}")
    leapfrog_halfstep_batch_cuda.launches += 1
    return z_out, r_out


leapfrog_halfstep_batch_cuda.launches = 0
