"""Dispatch for the port's kernels: one call site per op, routed by where
the tensors lie.

``OP_TABLE`` has the same 12 rows as ``repro/kernels/ops.py:OP_TABLE``.  A
ported row names its hand-written kernel (``route`` ``"cuda"``), its plain
PyTorch version and the TPU kernel it replaces; a row not ported yet has
``kernel=None`` and ``ref=None``.

For a ported op, tensors on the CPU take the plain version and tensors on a
card launch the kernel; a kernel that cannot build or launch raises rather
than falling back.  A ref-only row (no TPU kernel in the JAX package) names
its plain version once ported and runs it on every device.  A ported op
whose gradient is a kernel of its own names it in ``BACKWARD``, with its
plain version, routed the same way: the backward passes of ``rmsnorm`` and
``attention`` (TPU kernels of their own in the JAX package, reached through
its ``custom_vjp``s) and of ``enum_contract`` (which the JAX package
differentiates through its jnp reference).  Their launches are counted with
the rest.  ``ssd_scan``'s gradient is autograd through its plain version on
every device, as the JAX package's ``custom_vjp`` differentiates its jnp
reference.

Every row with a TPU kernel (nine of the 12) names its hand-written kernel
and its plain version; of the three ref-only rows, ``decode_attention`` and
``ssd_decode_step`` name their plain versions and ``mla_absorbed_decode``
waits for the MLA slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from . import enum_contract as _enum_contract
from . import flash_attention as _flash
from . import glm_potential, leapfrog, rwm_mala
from . import rmsnorm as _rmsnorm
from . import softmax_xent as _xent
from . import ssd_scan as _ssd


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

# The bfloat16 parity bound of the LM kernels (``rmsnorm``, ``attention``),
# elementwise: |kernel - plain| <= BF16_RTOL * |plain| + BF16_ATOL.  Kernel
# and plain version compute the same float32 value, up to summation order,
# and round it once to bfloat16, so they may land one bfloat16 step apart
# (2**-7 of the value at most); BF16_ATOL covers values near zero, where the
# float32 difference itself shows.  ``tol`` is the float32 bound.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-5

OP_TABLE = (
    OpSpec("attention", _flash.flash_attention_cuda,
           _flash.flash_attention_ref, "cuda",
           _K + "flash_attention.py:79", False, 2e-4),
    OpSpec("decode_attention", None, _flash.decode_attention_ref, None, None,
           False, 0.0),
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
    OpSpec("rmsnorm", _rmsnorm.rmsnorm_cuda, _rmsnorm.rmsnorm_ref, "cuda",
           _K + "rmsnorm.py:49", False, 2e-5),
    OpSpec("softmax_xent", _xent.softmax_xent_cuda, _xent.softmax_xent_ref,
           "cuda", _K + "softmax_xent.py:57", False, 1e-4),
    OpSpec("ssd_scan", _ssd.ssd_scan_cuda, _ssd.ssd_scan_ref, "cuda",
           _K + "ssd_scan.py:64", False, 1e-4),
    OpSpec("ssd_decode_step", None, _ssd.ssd_decode_step_ref, None, None,
           False, 0.0),
)

SPECS = {spec.name: spec for spec in OP_TABLE}
PORTED = tuple(spec.name for spec in OP_TABLE if spec.kernel is not None)
# backward kernels of ported ops; ``replaces`` is the TPU kernel's function
# where the JAX package has one
BACKWARD = {spec.name: spec for spec in (
    OpSpec("enum_contract_bwd", _enum_contract.enum_contract_bwd_cuda,
           _enum_contract.enum_contract_bwd_ref, "cuda", None, False, 1e-6),
    OpSpec("rmsnorm_bwd", _rmsnorm.rmsnorm_bwd_cuda, _rmsnorm.rmsnorm_bwd_ref,
           "cuda", _K + "rmsnorm.py:67", False, 2e-5),
    OpSpec("attention_dq", _flash.flash_attention_dq_cuda,
           _flash.flash_attention_dq_ref, "cuda",
           _K + "flash_attention.py:184", False, 2e-4),
    OpSpec("attention_dkv", _flash.flash_attention_dkv_cuda,
           _flash.flash_attention_dkv_ref, "cuda",
           _K + "flash_attention.py:184", False, 2e-4),
)}


def _counted():
    return {**{name: SPECS[name].kernel for name in PORTED},
            **{name: spec.kernel for name, spec in BACKWARD.items()}}


def _route(name, tensor):
    """The plain version for a tensor on the CPU, else the kernel."""
    spec = SPECS[name] if name in SPECS else BACKWARD[name]
    return spec.ref if tensor.device.type == "cpu" else spec.kernel


def attention(q, k, v, *, causal=True, scale=None, window=0):
    """GQA-aware attention over a whole sequence, ``q (B, S, H, dq), k (B,
    S, K, dq), v (B, S, K, dv) -> (B, S, H, dv)``, differentiable
    (:class:`~repro_torch.kernels.flash_attention.FlashAttention`).
    ``window > 0`` (a sliding window) takes the plain version on every
    device, as the JAX package's ``flash_attention`` hands it to its jnp
    reference."""
    if window:
        return _flash.flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                          window=window)[0]
    return _flash.FlashAttention.apply(
        q, k, v, causal, scale, _route("attention", q),
        _route("attention_dq", q), _route("attention_dkv", q))[0]


def decode_attention(q, k, v, mask, *, scale=None):
    """Single-query attention against a masked cache (a ref-only op: the
    plain version on every device)."""
    return SPECS["decode_attention"].ref(q, k, v, mask, scale=scale)


def rmsnorm(x, weight, eps=1e-6):
    """RMSNorm over the last axis, float32 statistics, result in x's dtype;
    differentiable (:class:`~repro_torch.kernels.rmsnorm.RMSNorm`)."""
    return _rmsnorm.RMSNorm.apply(x, weight, eps, _route("rmsnorm", x),
                                  _route("rmsnorm_bwd", x))


def softmax_xent(x, w_unembed, labels, *, z_loss_weight=0.0):
    """``x (T, d)``, ``w_unembed (d, V)``, ``labels (T,)`` -> ``(ce,
    z_loss)``, each (T,) float32, without the (T, V) float32 logits kept
    whole; differentiable in ``x`` and ``w_unembed``
    (:class:`~repro_torch.kernels.softmax_xent.SoftmaxXent`)."""
    return _xent.SoftmaxXent.apply(x, w_unembed, labels, z_loss_weight,
                                   _route("softmax_xent", x))


def ssd_scan(x, dt, A, B, C, *, chunk, D=None, h0=None):
    """The Mamba-2 SSD chunked scan, ``x (b, l, h, p)``, ``dt (b, l, h)``,
    ``A (h,)``, ``B, C (b, l, g, n)`` -> ``(y (b, l, h, p)`` in x's dtype,
    ``final state (b, h, p, n)`` float32), with an optional ``D (h,)`` and
    entering state ``h0``; differentiable
    (:class:`~repro_torch.kernels.ssd_scan.SsdScan`).  ``dt``, ``A``, ``D``
    and ``h0`` are taken in float32.  A length that is not a whole number of
    chunks raises on every device, as the reference asserts."""
    dt, A, D, h0 = (None if t is None else t.float()
                    for t in (dt, A, D, h0))
    return _ssd.SsdScan.apply(x, dt, A, B, C, D, h0, chunk,
                              _route("ssd_scan", x))


def ssd_decode_step(state, x, dt, A, B, C, *, D=None):
    """One token of the SSD recurrence, ``state (b, h, p, n)``, ``x (b, h,
    p)``, ``dt (b, h)``, ``B, C (b, g, n)`` -> ``(y (b, h, p), new state)``
    (a ref-only op: the plain version on every device)."""
    return SPECS["ssd_decode_step"].ref(state, x, dt, A, B, C, D=D)


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
