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

Inside a NUTS subtree the step runs fused into the leaf op,
``nuts_leaf``: one launch between two potential evaluations closes
leapfrog k (``r_k = r_half - (eps/2) * g``), forms its kinetic energy, the
subtree's momentum sum through it, its checkpoint row (an even leaf) or the
U-turn dots against the checkpoints (an odd leaf), packs ``[pe, ke,
dots...]`` for the leaf's one host read, and opens leapfrog k + 1 with the
step above.  ``nuts_turning`` forms the two U-turn dots of a merged tree.

``ops.leapfrog_halfstep``, ``ops.leapfrog_halfstep_batch``,
``ops.nuts_leaf`` and ``ops.nuts_turning`` take the plain versions for
tensors on the CPU and the CUDA kernels (``csrc/leapfrog.cu``,
``csrc/leapfrog_batch.cu``) for tensors on a card; they never fall back
from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "leapfrog_halfstep_f32",
           torch.float64: "leapfrog_halfstep_f64"}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


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


def _check_vectors(kernel, z, **others):
    """Raise unless ``z`` is a contiguous flat (D,) CUDA tensor of a
    supported dtype and every other operand matches it (a ``*ckpts``
    operand is (R, D))."""
    if z.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {z.device}")
    if z.dtype not in _DTYPES:
        raise TypeError(f"{kernel} supports float32/float64, got {z.dtype}")
    if z.dim() != 1:
        raise ValueError(f"{kernel} takes flat (D,) vectors, got shape "
                         f"{tuple(z.shape)}")
    if not z.is_contiguous():
        raise ValueError(f"{kernel} needs contiguous tensors")
    for name, t in others.items():
        rows = name.endswith("ckpts")
        ok = t.dim() == 2 and t.shape[1] == z.shape[0] if rows \
            else t.shape == z.shape
        if t.device != z.device or t.dtype != z.dtype or not ok:
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; expected {z.dtype} "
                f"{'(R, ' if rows else '('}{z.shape[0]},) on {z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} needs contiguous tensors ({name})")


def _device_scalar(value, name, z, kernel):
    """``value`` as a one-element tensor of ``z``'s dtype on its card (a
    Python number is copied there), for the kernel to read in place."""
    if isinstance(value, torch.Tensor):
        if value.device != z.device or value.numel() != 1:
            raise ValueError(f"{kernel}: {name} must be one element on "
                             f"{z.device}, got shape {tuple(value.shape)} "
                             f"on {value.device}")
        return value if value.dtype == z.dtype else value.to(z.dtype)
    return torch.full((1,), float(value), dtype=z.dtype, device=z.device)


def leapfrog_halfstep_cuda(z, r, grad, m_inv, eps):
    """Launch the CUDA kernel on the current stream.

    ``eps`` may be a Python number or a one-element tensor on the same
    device; as a tensor it is read by the kernel from device memory, so no
    value crosses to the host.  Raises on a wrong device, dtype, shape or
    layout, and on a failed build or launch.
    """
    name = "leapfrog_halfstep_cuda"
    _check_vectors(name, z, r=r, grad=grad, m_inv=m_inv)
    eps = _device_scalar(eps, "eps", z, name)
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


# The last-CTA folds' tickets: a zeroed int32 per (device, stream), which
# every kernel that takes one leaves at zero.  Launches on one stream run in
# order, so they share it; another stream gets its own.  A stream first
# seen under CUDA graph capture has its ticket zeroed by the captured fill.
_TICKETS = {}


def fold_ticket(device, stream):
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None:
        buf = torch.zeros(1, dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def nuts_turning_ref(inverse_mass_matrix, r_left, r_right, r_sum):
    """The two dot products of the generalized U-turn criterion
    (Betancourt) on momentum sums; ``r_left`` may carry a leading batch of
    checkpoints.  The tree turns where either is <= 0."""
    r_mid = r_sum - 0.5 * (r_left + r_right)
    return torch.stack([torch.sum(inverse_mass_matrix * r_left * r_mid, -1),
                        torch.sum(inverse_mass_matrix * r_right * r_mid, -1)])


def nuts_leaf_ref(r_half, z, grad, pe, m_inv, eps, r_sum, r_ckpts,
                  r_sum_ckpts, ckpt_i=None, idx_min=0, idx_max=-1):
    """The plain version of a NUTS leaf: the eager code of the tree, in its
    order.  ``grad`` and ``pe`` are the potential's at ``z``; ``r_sum`` is
    the subtree's momentum sum before this leaf (``None`` on its first
    leaf).  ``ckpt_i`` writes checkpoint row ``ckpt_i`` in place (an even
    leaf); otherwise the U-turn dots are formed against rows
    ``idx_min..idx_max`` (none if empty).  Returns ``(r, r_sum_through,
    vals, z_next, r_half_next)``: ``vals = [pe, ke, left dots..., right
    dots...]`` and the next leaf's opening kick and drift."""
    r = r_half - 0.5 * eps * grad
    ke = 0.5 * torch.dot(r, m_inv * r)
    r_sum_through = r if r_sum is None else r_sum + r
    parts = [pe.reshape(1), ke.reshape(1)]
    if ckpt_i is not None:
        r_ckpts[ckpt_i] = r
        r_sum_ckpts[ckpt_i] = r_sum_through
    elif idx_min <= idx_max:
        rc = r_ckpts[idx_min:idx_max + 1]
        subtree_r_sum = r_sum_through - r_sum_ckpts[idx_min:idx_max + 1] + rc
        parts.append(nuts_turning_ref(m_inv, rc, r, subtree_r_sum)
                     .reshape(-1))
    z_next, r_half_next = leapfrog_halfstep_ref(z, r, grad, m_inv, eps)
    return r, r_sum_through, torch.cat(parts), z_next, r_half_next


def _nuts_lib():
    lib = _build.load("leapfrog")
    if lib.nuts_leaf_f32.argtypes is None:
        for dt in _SUFFIX.values():
            fn = getattr(lib, f"nuts_leaf_{dt}")
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
                + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"nuts_turning_{dt}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
                + [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
        lib.nuts_reduce_ctas.argtypes = [ctypes.c_longlong]
        lib.nuts_reduce_ctas.restype = ctypes.c_int
        lib.nuts_leaf_max_rows.restype = ctypes.c_int
    return lib


def nuts_leaf_cuda(r_half, z, grad, pe, m_inv, eps, r_sum, r_ckpts,
                   r_sum_ckpts, ckpt_i=None, idx_min=0, idx_max=-1):
    """Launch ``nuts_leaf`` (``csrc/leapfrog.cu``) once on the current
    stream; the arguments and results are :func:`nuts_leaf_ref`'s.  ``eps``
    and ``pe`` are read from device memory (one element each on the card);
    the checkpoint row ``ckpt_i`` is written in place, every other output is
    fresh.  Vectors are bit-identical to the plain version's; ``ke`` and the
    dots are summed in another order.  Raises on a wrong device, dtype,
    shape, layout or checkpoint index, and on a failed build or launch."""
    name = "nuts_leaf_cuda"
    operands = {"r_half": r_half, "grad": grad, "m_inv": m_inv,
                "r_ckpts": r_ckpts, "r_sum_ckpts": r_sum_ckpts}
    if r_sum is not None:
        operands["r_sum"] = r_sum
    _check_vectors(name, z, **operands)
    depth = r_ckpts.shape[0]
    if r_sum_ckpts.shape[0] != depth:
        raise ValueError(f"{name}: r_ckpts and r_sum_ckpts have "
                         f"{depth} and {r_sum_ckpts.shape[0]} rows")
    lib = _nuts_lib()
    if ckpt_i is not None:
        if not 0 <= ckpt_i < depth:
            raise ValueError(f"{name}: ckpt_i {ckpt_i} is not a row of "
                             f"{depth} checkpoints")
        rows, idx_min = 0, 0
    else:
        rows = max(idx_max - idx_min + 1, 0)
        if rows and not 0 <= idx_min <= idx_max < depth:
            raise ValueError(f"{name}: rows {idx_min}..{idx_max} are not "
                             f"within {depth} checkpoints")
        if rows > lib.nuts_leaf_max_rows():
            raise ValueError(f"{name}: {rows} checkpoint rows, at most "
                             f"{lib.nuts_leaf_max_rows()}")
    eps = _device_scalar(eps, "eps", z, name)
    pe = _device_scalar(pe, "pe", z, name)
    d = z.numel()
    r_out, z_next, r_half_next = (torch.empty_like(z) for _ in range(3))
    r_sum_out = None if r_sum is None else torch.empty_like(z)
    vals = torch.empty(2 + 2 * rows, dtype=z.dtype, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    ctas = lib.nuts_reduce_ctas(d)
    part = ticket = None
    if ctas > 1:
        part = torch.empty(ctas * (1 + 2 * rows), dtype=torch.float64,
                           device=z.device)
        ticket = fold_ticket(z.device, stream)
    with torch.cuda.device(z.device):
        rc = getattr(lib, "nuts_leaf_" + _SUFFIX[z.dtype])(
            eps.data_ptr(), pe.data_ptr(), r_half.data_ptr(), z.data_ptr(),
            grad.data_ptr(), m_inv.data_ptr(),
            None if r_sum is None else r_sum.data_ptr(),
            r_ckpts.data_ptr(), r_sum_ckpts.data_ptr(),
            -1 if ckpt_i is None else ckpt_i, idx_min, rows, d,
            r_out.data_ptr(), None if r_sum_out is None else
            r_sum_out.data_ptr(), z_next.data_ptr(), r_half_next.data_ptr(),
            vals.data_ptr(), None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nuts_leaf kernel launch failed: cudaError {rc}")
    nuts_leaf_cuda.launches += 1
    r_sum_through = r_out if r_sum_out is None else r_sum_out
    return r_out, r_sum_through, vals, z_next, r_half_next


nuts_leaf_cuda.launches = 0


def nuts_turning_cuda(inverse_mass_matrix, r_left, r_right, r_sum):
    """Launch ``nuts_turning`` (``csrc/leapfrog.cu``) once on the current
    stream: the (2,) dots of :func:`nuts_turning_ref` for flat (D,)
    momenta, summed in another order.  Raises on a wrong device, dtype,
    shape or layout, and on a failed build or launch."""
    name = "nuts_turning_cuda"
    _check_vectors(name, r_left, inverse_mass_matrix=inverse_mass_matrix,
                   r_right=r_right, r_sum=r_sum)
    lib = _nuts_lib()
    d = r_left.numel()
    out = torch.empty(2, dtype=r_left.dtype, device=r_left.device)
    stream = torch.cuda.current_stream(r_left.device).cuda_stream
    ctas = lib.nuts_reduce_ctas(d)
    part = ticket = None
    if ctas > 1:
        part = torch.empty(2 * ctas, dtype=torch.float64,
                           device=r_left.device)
        ticket = fold_ticket(r_left.device, stream)
    with torch.cuda.device(r_left.device):
        rc = getattr(lib, "nuts_turning_" + _SUFFIX[r_left.dtype])(
            inverse_mass_matrix.data_ptr(), r_left.data_ptr(),
            r_right.data_ptr(), r_sum.data_ptr(), d, out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nuts_turning kernel launch failed: "
                           f"cudaError {rc}")
    nuts_turning_cuda.launches += 1
    return out


nuts_turning_cuda.launches = 0


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
