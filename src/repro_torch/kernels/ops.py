"""Dispatch for the port's kernels: one call site per op, routed by where
the tensors lie.

``OP_TABLE`` has the same 12 rows as ``repro/kernels/ops.py:OP_TABLE``.  A
ported row names its hand-written kernel (``route`` ``"cuda"``), its plain
PyTorch version and the TPU kernel it replaces; a row not ported yet has
``kernel=None`` and ``ref=None`` and stands in ROADMAP.md, Queue 2.

For a ported op, tensors on the CPU take the plain version and tensors on a
card launch the kernel; a kernel that cannot build or launch raises rather
than falling back.  A ported op whose gradient is a kernel of its own names
it in ``BACKWARD`` (the JAX package has no row for it: it differentiates
the jnp reference); its launches are counted with the rest.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from . import enum_contract as _enum_contract
from . import glm_potential, leapfrog, rwm_mala


class OpSpec(NamedTuple):
    """Registry entry for one op of the JAX package's table.

    ``kernel``/``ref`` are the CUDA wrapper and the plain version (``None``
    until ported); the wrapper carries the op's launch counter as its
    ``launches`` attribute.  ``route`` is ``"cuda"`` or ``"triton"`` once
    ported; ``replaces`` is the file:line of the JAX function that reaches
    ``pl.pallas_call`` (``None`` for the ref-only rows, which have no TPU
    kernel); ``tol`` is the parity bound between kernel and plain version
    (max-abs error).
    """

    name: str
    kernel: Optional[Callable]
    ref: Optional[Callable]
    route: Optional[str]
    replaces: Optional[str]
    bit_identical: bool
    tol: float


_K = "src/repro/kernels/"

OP_TABLE = (
    OpSpec("attention", None, None, None,
           _K + "flash_attention.py:79", False, 2e-4),
    OpSpec("decode_attention", None, None, None, None, False, 0.0),
    OpSpec("mla_absorbed_decode", None, None, None, None, False, 0.0),
    OpSpec("leapfrog_halfstep", leapfrog.leapfrog_halfstep_cuda,
           leapfrog.leapfrog_halfstep_ref, "cuda", _K + "leapfrog.py:40",
           False, 1e-6),
    OpSpec("leapfrog_halfstep_batch", leapfrog.leapfrog_halfstep_batch_cuda,
           leapfrog.leapfrog_halfstep_batch_ref, "cuda",
           _K + "leapfrog.py:104", False, 1e-6),
    OpSpec("glm_potential_grad", glm_potential.glm_potential_grad_cuda,
           glm_potential.glm_potential_grad_ref, "cuda",
           _K + "glm_potential.py:62", False, 5e-3),
    OpSpec("mala_step", rwm_mala.mala_step_cuda, rwm_mala.mala_step_ref,
           "cuda", _K + "rwm_mala.py:42", False, 1e-6),
    OpSpec("enum_contract", _enum_contract.enum_contract_cuda,
           _enum_contract.enum_contract_ref, "cuda",
           _K + "enum_contract.py:50", True, 0.0),
    OpSpec("rmsnorm", None, None, None, _K + "rmsnorm.py:49", False, 2e-5),
    OpSpec("softmax_xent", None, None, None,
           _K + "softmax_xent.py:57", False, 1e-4),
    OpSpec("ssd_scan", None, None, None, _K + "ssd_scan.py:64", False, 1e-4),
    OpSpec("ssd_decode_step", None, None, None, None, False, 0.0),
)

SPECS = {spec.name: spec for spec in OP_TABLE}
PORTED = tuple(spec.name for spec in OP_TABLE if spec.kernel is not None)
# backward kernels of ported ops (name -> CUDA wrapper)
BACKWARD = {"enum_contract_bwd": _enum_contract.enum_contract_bwd_cuda}


def _counted():
    return {**{name: SPECS[name].kernel for name in PORTED}, **BACKWARD}


def _route(name, tensor):
    """The plain version for a tensor on the CPU, else the kernel."""
    spec = SPECS[name]
    return spec.ref if tensor.device.type == "cpu" else spec.kernel


def leapfrog_halfstep(z, r, grad, m_inv, eps):
    """Fused momentum half-step + position full-step of velocity Verlet
    (diagonal mass): (z, r, grad, m_inv) flat (D,) tensors and a scalar or
    device-scalar ``eps`` -> (z', r')."""
    return _route("leapfrog_halfstep", z)(z, r, grad, m_inv, eps)


def leapfrog_halfstep_batch(z, r, grad, m_inv, eps, kick=0.5):
    """Chain-batched leapfrog kick + drift over a (C, D) ensemble with a
    shared (D,) ``m_inv``: ``r' = r - (kick * eps) * g``, ``z' = z + eps *
    (r' * m_inv)``; ``kick`` 0.5 is a half-kick, 1.0 the merged kick between
    interior steps; ``eps`` a host number -> (z', r')."""
    return _route("leapfrog_halfstep_batch", z)(z, r, grad, m_inv, eps, kick)


def glm_potential_grad(x, y, w, offset=None, scale=None,
                       family="bernoulli_logit"):
    """Fused GLM negative log-likelihood + gradient wrt ``w`` in one pass
    over the (n, d) design matrix: -> (nll scalar, grad (d,))."""
    return _route("glm_potential_grad", x)(x, y, w, offset, scale, family)


def mala_step(z, grad, noise, m_inv, eps):
    """Batched Langevin proposal over a (C, D) ensemble, ``z - eps * m_inv
    * grad + sqrt(2 * eps * m_inv) * noise``; ``grad=None`` gives the
    symmetric random-walk proposal; ``eps`` a host number."""
    return _route("mala_step", z)(z, grad, noise, m_inv, eps)


def enum_contract(log_alpha, log_mat):
    """``out[..., j] = logsumexp_i(log_alpha[..., i] + log_mat[..., i, j])``
    over ``(..., Ki) x (..., Ki, K) -> (..., K)``, differentiable: the plain
    versions for CPU tensors, the forward and backward kernels for CUDA
    tensors (:class:`~repro_torch.kernels.enum_contract.EnumContract`)."""
    return _enum_contract.EnumContract.apply(log_alpha, log_mat)


def launch_counts() -> dict:
    """Kernel launches per ported op (and backward kernel) since the last
    reset."""
    return {name: kernel.launches for name, kernel in _counted().items()}


def reset_launch_counts() -> None:
    for kernel in _counted().values():
        kernel.launches = 0
    rwm_mala.mala_step_cuda.launches_without_grad = 0
