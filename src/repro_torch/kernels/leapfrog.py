"""Fused leapfrog half-step for HMC/NUTS (diagonal mass).

One pass computes the momentum half-step and the position full-step:
``r' = r - (eps/2) * g`` and ``z' = z + eps * (r' * m_inv)``, where ``g``
is the gradient of the *potential* (the sign convention of
``hmc_util.velocity_verlet``).

The chain-batched form (``leapfrog_halfstep_batch``, the ChEES ensemble's
integrator) takes ``(C, D)`` positions, momenta and gradients with one
shared ``(D,)`` ``m_inv`` and a ``kick`` of 0.5 (a half-kick) or 1.0 (the
two half-kicks between interior steps merged):
``r' = r - (kick * eps) * g``, ``z' = z + eps * (r' * m_inv)``, with
``eps`` read from device memory, so a launch captured in a CUDA graph reads
the step size current at replay.  ``chees_open`` is the same kernel with
the momentum draw in front (``r = n / sqrt(m_inv)`` from the standard-normal
``n``, then the opening half-kick).  After a ChEES trajectory,
``chees_accept`` closes the transition in one launch: the closing
half-kick, both energies, the accept test, the selection, the running mean,
and in warmup the harmonic mean, the ChEES gradient and the pooled Welford
fold.

Inside a NUTS subtree the step runs fused into the leaf op,
``nuts_leaf``: one launch between two potential evaluations closes
leapfrog k (``r_k = r_half - (eps/2) * g``), forms its kinetic energy, the
subtree's momentum sum through it, its checkpoint row (an even leaf) or the
U-turn dots against the checkpoints (an odd leaf), packs ``[pe, ke,
dots...]`` for the leaf's one host read, and opens leapfrog k + 1 with the
step above.  ``nuts_turning`` forms the two U-turn dots of a merged tree.

Lockstep NUTS over C chains (``hmc_util.build_tree_batch``, the JAX
package's ``vmap`` of the leaf over chains) runs ``nuts_leaf_batch``: the
leaf of every chain in one launch, each chain with its own signed step
size, ``m_inv`` row, checkpoints and active flag (a chain whose tree or
subtree has stopped is copied through).  ``nuts_turning_batch`` forms the
(C, 2) dots of the merged trees, and ``halfstep_chains`` opens each chain's
subtree (and each leapfrog of lockstep HMC) with its own step size.

``ops.leapfrog_halfstep``, ``ops.leapfrog_halfstep_batch``,
``ops.nuts_leaf``, ``ops.nuts_turning``, their three chain-batched forms,
``ops.chees_open`` and ``ops.chees_accept`` take the plain versions for
tensors on the CPU and the CUDA kernels (``csrc/leapfrog.cu``, ``csrc/leapfrog_batch.cu``,
``csrc/chees.cu``) for tensors on a card; they never fall back from one to
the other.
"""
from __future__ import annotations

import ctypes
import math

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


# ---------------------------------------------------------------------------
# lockstep NUTS over C chains: nuts_leaf_batch, nuts_turning_batch,
# halfstep_chains
# ---------------------------------------------------------------------------

def halfstep_chains_ref(z, r, grad, m_inv, eps, active, *,
                        step=leapfrog_halfstep_ref):
    """The plain version of the half-step over C chains: row c is
    :func:`leapfrog_halfstep_ref` (or ``step``, a one-chain form with its
    arguments) on chain c with its own signed ``eps[c]`` and ``m_inv[c]``,
    an inactive row copied through -> ``(z', r')``."""
    z_new, r_new = zip(*(
        step(z[c], r[c], grad[c], m_inv[c], eps[c]) if on
        else (z[c], r[c]) for c, on in enumerate(active.tolist())))
    return torch.stack(z_new), torch.stack(r_new)


def nuts_leaf_batch_ref(r_half, z, grad, pe, m_inv, eps, active, r_sum,
                        r_ckpts, r_sum_ckpts, ckpt_i=None, idx_min=0,
                        idx_max=-1, *, leaf=nuts_leaf_ref):
    """The plain version of a lockstep leaf over C chains: row c is
    :func:`nuts_leaf_ref` (or ``leaf``, a one-chain form with its arguments)
    on chain c (its ``(C, D)`` rows, ``pe[c]``, its signed ``eps[c]``, its
    ``m_inv`` row and its (depth, D) block of the ``(C, depth, D)``
    checkpoints, written in place), in that function's order.  The
    checkpoint row or range is shared.  An inactive chain is copied
    through: ``r`` and ``r_half_next`` are its ``r_half``,
    ``r_sum_through`` its ``r_sum`` (``r_half`` on a first leaf),
    ``z_next`` its ``z``, its vals row is zero and its checkpoints are
    untouched.  Returns ``(r, r_sum_through, vals (C, 2 + 2 rows), z_next,
    r_half_next)``."""
    rows = 0 if ckpt_i is not None else max(idx_max - idx_min + 1, 0)
    outs = []
    for c, on in enumerate(active.tolist()):
        if on:
            outs.append(leaf(
                r_half[c], z[c], grad[c], pe[c], m_inv[c], eps[c],
                None if r_sum is None else r_sum[c], r_ckpts[c],
                r_sum_ckpts[c], ckpt_i, idx_min, idx_max))
        else:
            kept = r_half[c] if r_sum is None else r_sum[c]
            outs.append((r_half[c], kept, z.new_zeros(2 + 2 * rows), z[c],
                         r_half[c]))
    return tuple(torch.stack(t) for t in zip(*outs))


def nuts_turning_batch_ref(inverse_mass_matrix, r_left, r_right, r_sum, *,
                           dots=nuts_turning_ref):
    """The plain version of the (C, 2) U-turn dots of C trees: row c is
    :func:`nuts_turning_ref` (or ``dots``) on chain c."""
    return torch.stack([dots(inverse_mass_matrix[c], r_left[c], r_right[c],
                             r_sum[c]) for c in range(r_left.shape[0])])


def _check_chains(kernel, z, **others):
    """Raise unless ``z`` is a contiguous (C, D) CUDA tensor of a supported
    dtype and every other operand matches it: (C, D), a (C,) vector of its
    dtype (``eps``, ``pe``), a (C,) bool ``active`` or (C, R, D) checkpoints
    (``*ckpts``)."""
    if z.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {z.device}")
    if z.dtype not in _DTYPES:
        raise TypeError(f"{kernel} supports float32/float64, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"{kernel} takes (C, D) chains, got shape "
                         f"{tuple(z.shape)}")
    for name, t in others.items():
        dtype = torch.bool if name == "active" else z.dtype
        if name.endswith("ckpts"):
            ok = t.dim() == 3 and t.shape[0] == z.shape[0] \
                and t.shape[2] == z.shape[1]
        elif name in ("eps", "pe", "active"):
            ok = t.shape == z.shape[:1]
        else:
            ok = t.shape == z.shape
        if t.device != z.device or t.dtype != dtype or not ok:
            raise ValueError(f"{kernel}: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, which does "
                             f"not fit {z.dtype} {tuple(z.shape)} chains on "
                             f"{z.device}")
    if not all(t.is_contiguous() for t in (z, *others.values())):
        raise ValueError(f"{kernel} needs contiguous tensors")


# The chain-batched folds' tickets: C zeroed int32 per (device, stream), one
# a chain, left at zero by every launch; a wider batch gets a new buffer.
_CHAIN_TICKETS = {}


def fold_tickets(device, stream, chains):
    key = (device.index, stream)
    buf = _CHAIN_TICKETS.get(key)
    if buf is None or buf.numel() < chains:
        buf = torch.zeros(chains, dtype=torch.int32, device=device)
        _CHAIN_TICKETS[key] = buf
    return buf


def _batch_lib():
    lib = _nuts_lib()
    if lib.nuts_leaf_batch_f32.argtypes is None:
        for dt in _SUFFIX.values():
            fn = getattr(lib, f"nuts_leaf_batch_{dt}")
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
                + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 8
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"nuts_turning_batch_{dt}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
                + [ctypes.c_void_p] * 4
            fn.restype = ctypes.c_int
            fn = getattr(lib, f"halfstep_chains_{dt}")
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.nuts_batch_max_chains.restype = ctypes.c_int
    return lib


def _check_width(name, lib, chains):
    if chains > lib.nuts_batch_max_chains():
        raise ValueError(f"{name}: {chains} chains, at most "
                         f"{lib.nuts_batch_max_chains()}")


def halfstep_chains_cuda(z, r, grad, m_inv, eps, active):
    """Launch ``halfstep_chains`` (``csrc/leapfrog.cu``) once on the current
    stream: :func:`halfstep_chains_ref`'s arguments and results,
    bit-identical.  ``eps`` (C,) and ``active`` (C,) bool lie on the card.
    Raises on a wrong device, dtype, shape or layout, and on a failed build
    or launch."""
    name = "halfstep_chains_cuda"
    _check_chains(name, z, r=r, grad=grad, m_inv=m_inv, eps=eps,
                  active=active)
    lib = _batch_lib()
    chains, d = z.shape
    _check_width(name, lib, chains)
    z_out, r_out = torch.empty_like(z), torch.empty_like(r)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = getattr(lib, "halfstep_chains_" + _SUFFIX[z.dtype])(
            eps.data_ptr(), active.data_ptr(), z.data_ptr(), r.data_ptr(),
            grad.data_ptr(), m_inv.data_ptr(), z_out.data_ptr(),
            r_out.data_ptr(), chains, d, stream)
    if rc != 0:
        raise RuntimeError(f"halfstep_chains kernel launch failed: "
                           f"cudaError {rc}")
    halfstep_chains_cuda.launches += 1
    return z_out, r_out


halfstep_chains_cuda.launches = 0


def nuts_leaf_batch_cuda(r_half, z, grad, pe, m_inv, eps, active, r_sum,
                         r_ckpts, r_sum_ckpts, ckpt_i=None, idx_min=0,
                         idx_max=-1):
    """Launch ``nuts_leaf_batch`` (``csrc/leapfrog.cu``) once on the current
    stream for all C chains: :func:`nuts_leaf_batch_ref`'s arguments and
    results.  ``eps``, ``pe`` (C,) and ``active`` (C,) bool are read from
    device memory; the checkpoint row ``ckpt_i`` of each active chain is
    written in place.  Row c is bit-identical to a :func:`nuts_leaf_cuda`
    launch on chain c alone (vectors and sums); against the plain version
    the vectors are bit-identical and ``ke`` and the dots are summed in
    another order.  Raises on a wrong device, dtype, shape, layout or
    checkpoint index, and on a failed build or launch."""
    name = "nuts_leaf_batch_cuda"
    if pe.dtype != z.dtype:  # a potential in another dtype than the chain
        pe = pe.to(z.dtype)
    operands = {"r_half": r_half, "grad": grad, "m_inv": m_inv, "pe": pe,
                "eps": eps, "active": active, "r_ckpts": r_ckpts,
                "r_sum_ckpts": r_sum_ckpts}
    if r_sum is not None:
        operands["r_sum"] = r_sum
    _check_chains(name, z, **operands)
    depth = r_ckpts.shape[1]
    if r_sum_ckpts.shape[1] != depth:
        raise ValueError(f"{name}: r_ckpts and r_sum_ckpts have "
                         f"{depth} and {r_sum_ckpts.shape[1]} rows")
    lib = _batch_lib()
    chains, d = z.shape
    _check_width(name, lib, chains)
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
    r_out, z_next, r_half_next = (torch.empty_like(z) for _ in range(3))
    r_sum_out = None if r_sum is None else torch.empty_like(z)
    vals = torch.empty((chains, 2 + 2 * rows), dtype=z.dtype,
                       device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    ctas = lib.nuts_reduce_ctas(d)
    part = ticket = None
    if ctas > 1:
        part = torch.empty(chains * ctas * (1 + 2 * rows),
                           dtype=torch.float64, device=z.device)
        ticket = fold_tickets(z.device, stream, chains)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(z.device):
        rc = getattr(lib, "nuts_leaf_batch_" + _SUFFIX[z.dtype])(
            eps.data_ptr(), pe.data_ptr(), active.data_ptr(),
            r_half.data_ptr(), z.data_ptr(), grad.data_ptr(),
            m_inv.data_ptr(), ptr(r_sum), r_ckpts.data_ptr(),
            r_sum_ckpts.data_ptr(), depth, -1 if ckpt_i is None else ckpt_i,
            idx_min, rows, chains, d, r_out.data_ptr(), ptr(r_sum_out),
            z_next.data_ptr(), r_half_next.data_ptr(), vals.data_ptr(),
            ptr(part), ptr(ticket), stream)
    if rc != 0:
        raise RuntimeError(f"nuts_leaf_batch kernel launch failed: "
                           f"cudaError {rc}")
    nuts_leaf_batch_cuda.launches += 1
    r_sum_through = r_out if r_sum_out is None else r_sum_out
    return r_out, r_sum_through, vals, z_next, r_half_next


nuts_leaf_batch_cuda.launches = 0


def nuts_turning_batch_cuda(inverse_mass_matrix, r_left, r_right, r_sum):
    """Launch ``nuts_turning_batch`` (``csrc/leapfrog.cu``) once on the
    current stream: the (C, 2) dots of :func:`nuts_turning_batch_ref`, row c
    bit-identical to a :func:`nuts_turning_cuda` launch on chain c (summed
    in another order than the plain version).  Raises on a wrong device,
    dtype, shape or layout, and on a failed build or launch."""
    name = "nuts_turning_batch_cuda"
    _check_chains(name, r_left, inverse_mass_matrix=inverse_mass_matrix,
                  r_right=r_right, r_sum=r_sum)
    lib = _batch_lib()
    chains, d = r_left.shape
    _check_width(name, lib, chains)
    out = torch.empty((chains, 2), dtype=r_left.dtype, device=r_left.device)
    stream = torch.cuda.current_stream(r_left.device).cuda_stream
    ctas = lib.nuts_reduce_ctas(d)
    part = ticket = None
    if ctas > 1:
        part = torch.empty(chains * ctas * 2, dtype=torch.float64,
                           device=r_left.device)
        ticket = fold_tickets(r_left.device, stream, chains)
    with torch.cuda.device(r_left.device):
        rc = getattr(lib, "nuts_turning_batch_" + _SUFFIX[r_left.dtype])(
            inverse_mass_matrix.data_ptr(), r_left.data_ptr(),
            r_right.data_ptr(), r_sum.data_ptr(), chains, d, out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nuts_turning_batch kernel launch failed: "
                           f"cudaError {rc}")
    nuts_turning_batch_cuda.launches += 1
    return out


nuts_turning_batch_cuda.launches = 0


_BATCH_DTYPES = {torch.float32: "leapfrog_halfstep_batch_f32",
                 torch.float64: "leapfrog_halfstep_batch_f64"}
_OPEN_DTYPES = {torch.float32: "chees_open_f32",
                torch.float64: "chees_open_f64"}


def _into(out, z_new, r_new):
    """``(z_new, r_new)``, or copied into ``out = (z_out, r_out)``."""
    if out is None:
        return z_new, r_new
    out[0].copy_(z_new)
    out[1].copy_(r_new)
    return out


def leapfrog_halfstep_batch_ref(z, r, grad, m_inv, eps, kick=0.5, out=None):
    """The plain PyTorch version of the batch op, in ``promote(dtype,
    float32)`` like the TPU kernel (float64 stays float64); ``out`` takes
    the results in place."""
    z_dtype, r_dtype = z.dtype, r.dtype
    cd = torch.promote_types(z_dtype, torch.float32)
    if not isinstance(eps, torch.Tensor):
        eps = float(eps)  # a numpy scalar would turn the product into numpy
    kick = float(kick)
    z, r, grad, m_inv = (t.to(cd) for t in (z, r, grad, m_inv))
    r_new = r - (kick * eps) * grad
    return _into(out, (z + eps * (r_new * m_inv)).to(z_dtype),
                 r_new.to(r_dtype))


def chees_open_ref(z, n, grad, m_inv, eps, out=None):
    """The plain version of a ChEES trajectory's opening: the momenta from
    the standard-normal draw ``n`` (``hmc_util.momentum_sample``'s ``n /
    sqrt(m_inv)``), then the opening half-kick and drift of
    :func:`leapfrog_halfstep_batch_ref`."""
    r0 = n / torch.sqrt(m_inv)
    return leapfrog_halfstep_batch_ref(z, r0, grad, m_inv, eps, 0.5, out)


def host_scalar(value, name, kernel):
    """``value`` as a Python float for a kernel that takes it by value; a
    tensor on a card is refused (reading it would wait for the device)."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu" or value.numel() != 1:
            raise ValueError(f"{kernel}: {name} must be a host number (the "
                             f"kernel takes it by value), got a tensor of "
                             f"shape {tuple(value.shape)} on {value.device}")
    return float(value)


# check_ensemble's operands of one value a chain; m_inv and wf_* are rows
_PER_CHAIN = ("pe0", "pe1", "u", "mean_accept_prob")


def check_ensemble(kernel, dtypes, z, **others):
    """Raise unless ``z`` is a contiguous (C, D) CUDA tensor of a supported
    dtype and every other operand matches it: (C, D), a (D,) row
    (``m_inv``, ``wf_*``) or a (C,) vector (``_PER_CHAIN``)."""
    if z.device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {z.device}")
    if z.dtype not in dtypes:
        raise TypeError(f"{kernel} supports float32/float64, got {z.dtype}")
    if z.dim() != 2:
        raise ValueError(f"{kernel} takes a (C, D) ensemble, got shape "
                         f"{tuple(z.shape)}")
    for name, t in others.items():
        shape = z.shape[1:] if name.startswith(("m_inv", "wf_")) \
            else z.shape[:1] if name in _PER_CHAIN else z.shape
        if t.device != z.device or t.dtype != z.dtype or t.shape != shape:
            raise ValueError(
                f"{kernel}: {name} is {t.dtype} {tuple(t.shape)} on "
                f"{t.device}; expected {z.dtype} {tuple(shape)} on "
                f"{z.device}")
    if not all(t.is_contiguous() for t in (z, *others.values())):
        raise ValueError(f"{kernel} needs contiguous tensors")


def _out_pair(kernel, z, r, out):
    """The output pair of a batch launch: fresh, or ``out`` checked (it may
    be ``(z, r)`` itself: each element is read and written by one thread)."""
    if out is None:
        return torch.empty_like(z), torch.empty_like(r)
    check_ensemble(kernel, _BATCH_DTYPES, z, z_out=out[0], r_out=out[1])
    return out


def _batch_launch(name, symbol, z, r, grad, m_inv, eps, kick, out):
    """One launch of ``csrc/leapfrog_batch.cu``'s ``symbol``: row 3 with
    ``kick``, or ``chees_open`` (``kick=None``, ``r`` the draw)."""
    check_ensemble(name, _BATCH_DTYPES, z, r=r, grad=grad, m_inv=m_inv)
    eps = _device_scalar(eps, "eps", z, name)
    z_out, r_out = _out_pair(name, z, r, out)
    fn = getattr(_build.load("leapfrog_batch"), symbol)
    if fn.argtypes is None:
        by_value = [] if kick is None else [ctypes.c_double]
        fn.argtypes = [ctypes.c_void_p] * 7 + by_value \
            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rows, cols = z.shape
    ptrs = (z.data_ptr(), r.data_ptr(), grad.data_ptr(), m_inv.data_ptr(),
            eps.data_ptr(), z_out.data_ptr(), r_out.data_ptr())
    stream = torch.cuda.current_stream(z.device).cuda_stream
    with torch.cuda.device(z.device):
        rc = fn(*ptrs, *(() if kick is None else (kick,)), rows, cols,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name.removesuffix('_cuda')} kernel launch "
                           f"failed: cudaError {rc}")
    return z_out, r_out


def leapfrog_halfstep_batch_cuda(z, r, grad, m_inv, eps, kick=0.5,
                                 out=None):
    """Launch ``csrc/leapfrog_batch.cu`` on the current stream: one thread
    per element of the (C, D) ensemble.  ``eps`` is read by the kernel from
    a one-element device tensor of the ensemble's dtype (a host number is
    staged there first); ``kick`` (0.5 or 1.0) is a host number passed by
    value; ``out = (z_out, r_out)`` takes the results, in place when it is
    ``(z, r)``.  Raises on a wrong device, dtype, shape or layout, on
    another ``kick``, and on a failed build or launch."""
    name = "leapfrog_halfstep_batch_cuda"
    kick = host_scalar(kick, "kick", name)
    if kick not in (0.5, 1.0):
        raise ValueError(f"{name}: kick must be 0.5 or 1.0, got {kick}")
    res = _batch_launch(name, _BATCH_DTYPES.get(z.dtype), z, r, grad, m_inv,
                        eps, kick, out)
    leapfrog_halfstep_batch_cuda.launches += 1
    return res


leapfrog_halfstep_batch_cuda.launches = 0


def chees_open_cuda(z, n, grad, m_inv, eps, out=None):
    """Launch ``chees_open`` (``csrc/leapfrog_batch.cu``: row 3's kernel
    with the momentum draw in front) on the current stream: the arguments
    and results are :func:`chees_open_ref`'s, bit-identical; ``eps`` as in
    :func:`leapfrog_halfstep_batch_cuda`; ``out = (z_out, r_out)`` may hold
    ``z`` (in place).  Raises on a wrong device, dtype, shape or layout, and
    on a failed build or launch."""
    res = _batch_launch("chees_open_cuda", _OPEN_DTYPES.get(z.dtype), z, n,
                        grad, m_inv, eps, None, out)
    chees_open_cuda.launches += 1
    return res


chees_open_cuda.launches = 0


# ---------------------------------------------------------------------------
# the close of a ChEES transition: chees_accept
# ---------------------------------------------------------------------------

def chain_sum(x):
    """Sum over the leading (chain) axis by the JAX package's fixed pairwise
    fold (halves added, an odd row carried), not ``torch.sum``: the pooled
    statistics then have the reference's association exactly."""
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        folded = x[:half] + x[half:2 * half]
        if n % 2:
            folded = torch.cat([folded, x[2 * half:]], 0)
        x = folded
    return x[0]


def harmonic_mean_accept(accept_prob):
    """The chains' harmonic-mean accept probability (the worst chains
    dominate), on the device."""
    return 1.0 / (chain_sum(1.0 / torch.clamp(accept_prob, min=1e-10))
                  / accept_prob.shape[0])


def chees_gradient(h, z0, z1, v1, weights):
    """Rao-Blackwellized Monte Carlo estimate of d ChEES / d log trajectory
    length, on the device.  ``z0``/``z1`` are the (C, D) initial and
    proposed positions, ``v1`` the final velocities, ``weights`` the chains'
    accept probabilities (0 for divergent chains).  A divergent proposal
    carries non-finite coordinates, so it is zeroed before any arithmetic
    (``0 * inf`` would poison the estimate); an all-divergent ensemble gives
    0."""
    keep = (weights > 0)[:, None]
    z1 = torch.where(keep, z1, 0.0)
    v1 = torch.where(keep, v1, 0.0)
    w_sum = torch.clamp(chain_sum(weights), min=1e-10)
    w = weights[:, None]
    z0c = z0 - chain_sum(w * z0) / w_sum
    z1c = torch.where(keep, z1 - chain_sum(w * z1) / w_sum, 0.0)
    per_chain = h * (torch.sum(z1c * z1c, -1) - torch.sum(z0c * z0c, -1)) \
        * torch.sum(z1c * v1, -1)
    grad = chain_sum(weights * per_chain) / w_sum
    return torch.where(torch.isfinite(grad), grad, 0.0)


def welford_moments(x):
    """The mean and the summed squared deviations of the rows of ``x``
    (``(batch, dim)``), each reduced with :func:`chain_sum`: the arithmetic
    of ``hmc_util.welford_batch``."""
    mean = chain_sum(x) / x.shape[0]
    centered = x - mean
    return mean, chain_sum(centered * centered)


def welford_merge(mean_a, m2_a, mean_b, m2_b, ratio_mean, ratio_m2):
    """Chan et al.'s merge of two accumulators' ``(mean, m2)``, with the
    count ratios ``n_b / n`` and ``n_a n_b / n`` as host numbers: the
    arithmetic of ``hmc_util.welford_combine``."""
    delta = mean_b - mean_a
    return mean_a + delta * ratio_mean, \
        m2_a + m2_b + (delta * delta) * ratio_m2


def chees_accept_ref(z0, pe0, g0, n, m_inv, z1, r, pe1, g1, eps, u,
                     max_delta_energy, mean_accept_prob, n_post, h=None,
                     welford=None):
    """The plain version of a ChEES transition's close: the eager code of
    ``ensemble.py``'s ``sample_fn`` after the trajectory, in its order.

    ``z0``/``pe0``/``g0`` are the state's, ``n`` the (C, D) standard-normal
    draw the momenta came from, ``z1``, ``r``, ``pe1``, ``g1`` the
    trajectory's end before its closing half-kick, ``eps`` the step size, ``u``
    the (C,) accept uniforms.  ``n_post > 0`` is the post-warmup draw count
    of the running mean; ``n_post == 0`` is warmup, which packs ``stats =
    [harmonic mean, ChEES gradient]`` for the host's one read (``h`` the
    trajectory's jitter; ``h=None`` leaves the gradient 0) and, given
    ``welford = (mean, m2, ratio_mean, ratio_m2)``, folds the selected z
    into the pooled accumulator.  Returns ``(z, pe, grad, energy,
    accept_prob, diverging, mean_accept_prob, stats, (mean, m2))``; in
    warmup the mean is ``accept_prob`` itself, after it ``stats`` and the
    fold are ``None``."""
    r0 = n / torch.sqrt(m_inv)  # momentum_sample
    # kinetic_energy, 0.5 r . (m_inv r), of the opening and closing momenta
    energy_cur = pe0 + 0.5 * torch.sum(r0 * (m_inv * r0), -1)
    r1 = r - 0.5 * eps * g1  # the closing half-kick
    energy_new = pe1 + 0.5 * torch.sum(r1 * (m_inv * r1), -1)
    delta = torch.where(torch.isnan(energy_new), math.inf,
                        energy_new - energy_cur)
    accept_prob = torch.clamp(torch.exp(-delta), max=1.0)
    diverging = delta > max_delta_energy
    accept = u < accept_prob
    acc2 = accept[:, None]
    z = torch.where(acc2, z1, z0)
    pe = torch.where(accept, pe1, pe0)
    grad = torch.where(acc2, g1, g0)
    energy = torch.where(accept, energy_new, energy_cur)
    if n_post > 0:
        mean_ap = mean_accept_prob \
            + (accept_prob - mean_accept_prob) / n_post
        return z, pe, grad, energy, accept_prob, diverging, mean_ap, None, \
            None
    parts = [harmonic_mean_accept(accept_prob)]
    if h is None:
        parts.append(torch.zeros_like(parts[0]))
    else:
        weights = torch.where(diverging, 0.0, accept_prob)
        parts.append(chees_gradient(float(h), z0, z1, m_inv * r1, weights))
    folded = None
    if welford is not None:
        mean, m2, ratio_mean, ratio_m2 = welford
        folded = welford_merge(mean, m2, *welford_moments(z), ratio_mean,
                               ratio_m2)
    return z, pe, grad, energy, accept_prob, diverging, accept_prob, \
        torch.stack(parts), folded


def chees_accept_scale(z0, pe0, g0, n, m_inv, z1, r, pe1, g1, eps, *_):
    """Each chain's sum of the magnitudes of the terms its energy change
    adds up (|pe0|, a finite |pe1| and the two kinetic energies' terms), in
    float64: kernel and plain version sum them in another order, so the
    energies may move by a relative tolerance of this, accept_prob by
    expm1 of that of itself."""
    m = m_inv.double()
    r0 = n.double() / torch.sqrt(m)
    r1 = r.double() - 0.5 * torch.as_tensor(eps).double() * g1.double()
    return pe0.double().abs() + pe1.double().abs().nan_to_num(
        nan=0.0, posinf=0.0) + 0.5 * (r0 * m * r0).sum(-1) \
        + 0.5 * (r1 * m * r1).sum(-1)


_ACCEPT = {torch.float32: "chees_accept_f32",
           torch.float64: "chees_accept_f64"}
# flags of csrc/chees.cu
_STATS, _GRAD, _FOLD = 1, 2, 4


def _accept_lib():
    lib = _build.load("chees")
    if lib.chees_accept_f32.argtypes is None:
        for fn in (lib.chees_accept_f32, lib.chees_accept_f64):
            fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_double] * 4 \
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 14
            fn.restype = ctypes.c_int
        lib.chees_accept_ctas.argtypes = [ctypes.c_longlong,
                                          ctypes.c_longlong, ctypes.c_int]
        lib.chees_accept_ctas.restype = ctypes.c_int
        lib.chees_accept_max_chains.restype = ctypes.c_int
    return lib


# CTAs of a launch per (device, C, D, dtype): the cooperative grid's size
_CTAS = {}


def chees_accept_cuda(z0, pe0, g0, n, m_inv, z1, r, pe1, g1, eps, u,
                      max_delta_energy, mean_accept_prob, n_post, h=None,
                      welford=None, sums=None):
    """Launch ``chees_accept`` (``csrc/chees.cu``) once on the current
    stream: a cooperative grid of column tiles, each with all C rows of its
    columns.  The arguments and results are :func:`chees_accept_ref`'s;
    ``eps`` is read from a one-element device tensor (a host number is
    staged there); the fold's ``(mean, m2)`` are fresh tensors.  ``sums``, a
    (C, 5) tensor, receives the five sums over D of each chain, rounded to
    its dtype: ke0, ke1, |z1c|^2, |z0c|^2, z1c . v1 (0 without the
    gradient).  The selections, the running mean, the harmonic mean and the
    fold are bit-identical to the plain version's on the card for the same
    accept_prob; the sums are taken in double, in another order.  Raises on
    a wrong device, dtype, shape or layout, on more chains than the kernel
    takes, and on a failed build or launch."""
    name = "chees_accept_cuda"
    n_post = int(n_post)
    if n_post < 0:
        raise ValueError(f"{name}: n_post must be >= 0, got {n_post}")
    if n_post > 0 and (h is not None or welford is not None):
        raise ValueError(f"{name}: the gradient and the Welford fold are "
                         "warmup's (n_post == 0)")
    per_chain = dict(pe0=pe0, pe1=pe1, u=u)
    if n_post > 0:
        per_chain["mean_accept_prob"] = mean_accept_prob
    fold = {}
    if welford is not None:
        fold = dict(wf_mean=welford[0], wf_m2=welford[1])
    check_ensemble(name, _ACCEPT, z0, g0=g0, n=n, m_inv=m_inv, z1=z1, r=r,
                   g1=g1, **per_chain, **fold)
    rows, cols = z0.shape
    if sums is not None:
        if sums.shape != (rows, 5) or sums.dtype != z0.dtype \
                or sums.device != z0.device or not sums.is_contiguous():
            raise ValueError(f"{name}: sums must be a contiguous "
                             f"{z0.dtype} ({rows}, 5) tensor on {z0.device}")
    lib = _accept_lib()
    if rows > lib.chees_accept_max_chains():
        raise ValueError(f"{name}: {rows} chains, at most "
                         f"{lib.chees_accept_max_chains()}")
    eps = _device_scalar(eps, "eps", z0, name)
    key = (z0.device.index, rows, cols, z0.dtype)
    ctas = _CTAS.get(key)
    if ctas is None:
        with torch.cuda.device(z0.device):
            ctas = lib.chees_accept_ctas(rows, cols,
                                         int(z0.dtype == torch.float64))
        if ctas < 1:
            raise RuntimeError(f"{name}: no launch fits ({rows}, {cols})")
        _CTAS[key] = ctas
    flags = 0 if n_post else _STATS | (_GRAD if h is not None else 0) \
        | (_FOLD if welford is not None else 0)
    z, grad = torch.empty_like(z0), torch.empty_like(g0)
    pe, energy, accept_prob = (torch.empty_like(pe0) for _ in range(3))
    diverging = torch.empty(rows, dtype=torch.bool, device=z0.device)
    mean_out = torch.empty_like(pe0) if n_post else None
    stats = None if n_post else torch.empty(2, dtype=z0.dtype,
                                            device=z0.device)
    folded = None if welford is None else (torch.empty_like(welford[0]),
                                           torch.empty_like(welford[1]))
    if sums is None:
        sums = torch.empty((rows, 5), dtype=z0.dtype, device=z0.device)
    # the gradient's weighted column means of z0 and z1
    colmean = None if h is None or n_post else torch.empty(
        2 * cols, dtype=z0.dtype, device=z0.device)
    part = torch.empty(ctas * 5 * rows, dtype=torch.float64,
                       device=z0.device)
    ratios = (0.0, 0.0) if welford is None else (float(welford[2]),
                                                  float(welford[3]))

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(z0.device).cuda_stream
    with torch.cuda.device(z0.device):
        rc = getattr(lib, _ACCEPT[z0.dtype])(
            z0.data_ptr(), pe0.data_ptr(), g0.data_ptr(), n.data_ptr(),
            m_inv.data_ptr(), z1.data_ptr(), r.data_ptr(), pe1.data_ptr(),
            g1.data_ptr(), eps.data_ptr(), u.data_ptr(),
            ptr(mean_accept_prob if n_post else None),
            ptr(fold.get("wf_mean")), ptr(fold.get("wf_m2")),
            float(max_delta_energy), 0.0 if h is None else float(h),
            *ratios, n_post, flags, rows, cols, ctas, z.data_ptr(),
            pe.data_ptr(), grad.data_ptr(), energy.data_ptr(),
            accept_prob.data_ptr(), diverging.data_ptr(), ptr(mean_out),
            ptr(stats), *(ptr(t) for t in folded or (None, None)),
            sums.data_ptr(), ptr(colmean), part.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"chees_accept kernel launch failed: cudaError "
                           f"{rc}")
    chees_accept_cuda.launches += 1
    mean_ap = mean_out if n_post else accept_prob
    return z, pe, grad, energy, accept_prob, diverging, mean_ap, stats, \
        folded


chees_accept_cuda.launches = 0
