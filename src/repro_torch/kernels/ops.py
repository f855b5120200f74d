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
its ``custom_vjp``s), of ``enum_contract`` (which the JAX package
differentiates through its jnp reference) and of ``softmax_xent`` in
bfloat16 (the JAX package's ``_bwd`` is ``jax.grad`` of its jnp reference;
a float32 ``softmax_xent`` takes the plain backward on every device).
Their launches are counted with the rest.  ``ssd_scan``'s gradient is
autograd through its plain version on every device, as the JAX package's
``custom_vjp`` differentiates its jnp reference.

Every row with a TPU kernel (nine of the 12) names its hand-written kernel
and its plain version; the three ref-only rows, ``decode_attention``,
``mla_absorbed_decode`` and ``ssd_decode_step``, name their plain versions.
The tables are held to the public ops of this module, to each other's
signatures and, on a card, kernel against plain version by
:mod:`repro_torch.lint_rules.invariants` (RPL201-203).

``FUSED`` holds the port's ops that run in one launch what the JAX package
does around or in a loop over a ported op: ``enum_chain``, the T-1
``enum_contract`` steps of ``markov``'s ``lax.scan`` (in marginal mode,
and as the forward filter of its sample mode), with its backward
``enum_chain_bwd`` in ``BACKWARD``; ``enum_chain_sample``, the sample
mode's backward scan of Gumbel-max draws; ``nuts_leaf``, a NUTS leaf's closing
kick, energy, momentum sum, checkpoint or U-turn dots and the next leaf's
``leapfrog_halfstep``, and ``nuts_turning``, a merged tree's U-turn dots;
their chain-batched forms for lockstep NUTS, ``nuts_leaf_batch``,
``nuts_turning_batch`` and ``halfstep_chains`` (a subtree's opening with a
step size per chain);
``mala_accept``, the MALA/RWM accept step after ``mala_step``'s proposal;
``chees_open``, a ChEES trajectory's momentum draw and opening half-kick in
row 3's kernel, and ``chees_accept``, the transition's close after it;
``glm_potential_partials``, the per-shard partials of the data-sharded
potential, which the JAX package computes with one ``glm_potential_grad``
call per shard, in one launch of row 2's kernel over a shard grid
dimension.
They are routed like the rest and their launches are counted with them.

Under a device mesh the LM ops take DTensors: ``rmsnorm``, ``attention``
and ``softmax_xent`` (with their ``BACKWARD`` rows) run through
``torch.distributed.tensor.experimental.local_map``, each declaring the
layout its kernel needs (:func:`_mesh_rmsnorm`, :func:`_mesh_attention`,
:func:`_mesh_softmax_xent`), so the autograd Functions and the kernel
launches see only each rank's local tensors and the counters count per
rank.  A DTensor that reaches :func:`_route` raises.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..distributed.sharding import grad_placements
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
    (max-abs error), or with ``relative`` relative to each output's largest
    entry (``|kernel - plain| <= tol * max(1, max|plain|)``), where the
    row's outputs are sums whose rounding grows with their terms; an output
    in bfloat16 is held to ``BF16_RTOL``/``BF16_ATOL`` instead.  ``also``
    names the other public ops of ``ops`` that run this row's kernel and
    plain version, with the same launch counter.  ``scale``, for a row
    whose output is the exp of a sum (an accept probability), gives from
    the op's arguments each chain's sum of the magnitudes of the summed
    terms: the sum may move by ``tol`` of it, so the output (at most 1) by
    ``expm1(tol * scale)``.
    """

    name: str
    kernel: Optional[Callable]
    ref: Optional[Callable]
    route: Optional[str]
    replaces: Optional[str]
    bit_identical: bool
    tol: float
    relative: bool = False
    also: tuple = ()
    scale: Optional[Callable] = None


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
    OpSpec("mla_absorbed_decode", None, _flash.mla_absorbed_decode_ref, None,
           None, False, 0.0),
    OpSpec("leapfrog_halfstep", leapfrog.leapfrog_halfstep_cuda,
           leapfrog.leapfrog_halfstep_ref, "cuda", _K + "leapfrog.py:40",
           False, 1e-6),
    OpSpec("leapfrog_halfstep_batch", leapfrog.leapfrog_halfstep_batch_cuda,
           leapfrog.leapfrog_halfstep_batch_ref, "cuda",
           _K + "leapfrog.py:104", False, 1e-6),
    # w (d,), or (C, d) for an ensemble: one launch reads x for all C
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
    # within 1e-6 of each output's largest entry (summation order)
    OpSpec("enum_contract_bwd", _enum_contract.enum_contract_bwd_cuda,
           _enum_contract.enum_contract_bwd_ref, "cuda", None, False, 1e-6,
           relative=True),
    # dw sums over every row: within 2e-5 of its largest entry
    OpSpec("rmsnorm_bwd", _rmsnorm.rmsnorm_bwd_cuda, _rmsnorm.rmsnorm_bwd_ref,
           "cuda", _K + "rmsnorm.py:67", False, 2e-5, relative=True),
    OpSpec("attention_dq", _flash.flash_attention_dq_cuda,
           _flash.flash_attention_dq_ref, "cuda",
           _K + "flash_attention.py:184", False, 2e-4),
    OpSpec("attention_dkv", _flash.flash_attention_dkv_cuda,
           _flash.flash_attention_dkv_ref, "cuda",
           _K + "flash_attention.py:184", False, 2e-4),
    # bfloat16 only: dx and dw within one bf16 step (BF16_RTOL)
    OpSpec("softmax_xent_bwd", _xent.softmax_xent_bwd_cuda,
           _xent.softmax_xent_bwd, "cuda", None, False, 0.0),
    # bit-identical to T-1 launches of enum_contract_bwd; within (T-1) x
    # 1e-6 of its largest entry against the plain chain (summation order)
    OpSpec("enum_chain_bwd", _enum_contract.enum_chain_bwd_cuda,
           _enum_contract.enum_chain_bwd_ref, "cuda", None, False, 1e-6,
           relative=True),
)}
# fused work around or over a ported op; ``replaces`` is the JAX package's
# code it runs (``nuts_leaf``: row 1's TPU kernel, which it runs fused)
_I = "src/repro/core/infer/"
FUSED = {spec.name: spec for spec in (
    # also markov's forward filter in sample mode (enum.py:612, the same
    # scan keeping every alpha): ``enum_chain_alphas``, the same kernel and
    # launch counter
    OpSpec("enum_chain", _enum_contract.enum_chain_cuda,
           _enum_contract.enum_chain_ref, "cuda", _I + "enum.py:600", True,
           0.0, also=("enum_chain_alphas",)),
    # the sample mode's backward scan of random.categorical draws (plain
    # jnp in the JAX package): the draws bit-identical
    OpSpec("enum_chain_sample", _enum_contract.enum_chain_sample_cuda,
           _enum_contract.enum_chain_sample_ref, "cuda", _I + "enum.py:619",
           True, 0.0),
    # vectors bit-identical; ke and the dots within 1e-6 relative
    OpSpec("nuts_leaf", leapfrog.nuts_leaf_cuda, leapfrog.nuts_leaf_ref,
           "cuda", _K + "leapfrog.py:40", False, 1e-6, relative=True),
    OpSpec("nuts_turning", leapfrog.nuts_turning_cuda,
           leapfrog.nuts_turning_ref, "cuda", _I + "hmc_util.py:494", False,
           1e-6, relative=True),
    # lockstep NUTS over C chains (the JAX package's vmap of the two ops
    # above): row c bit-identical to a one-chain launch on the card; against
    # the plain versions the vectors bit-identical, ke and the dots within
    # 1e-6 relative
    OpSpec("nuts_leaf_batch", leapfrog.nuts_leaf_batch_cuda,
           leapfrog.nuts_leaf_batch_ref, "cuda", _K + "leapfrog.py:40", False,
           1e-6, relative=True),
    OpSpec("nuts_turning_batch", leapfrog.nuts_turning_batch_cuda,
           leapfrog.nuts_turning_batch_ref, "cuda", _I + "hmc_util.py:494",
           False, 1e-6, relative=True),
    # row 1's half-step with a signed step size, m_inv row and active flag
    # per chain: bit-identical
    OpSpec("halfstep_chains", leapfrog.halfstep_chains_cuda,
           leapfrog.halfstep_chains_ref, "cuda", _K + "leapfrog.py:40", True,
           0.0),
    # selections, the running mean and the harmonic mean bit-identical for
    # the same accept_prob; log_accept within 1e-6 of its terms'
    # magnitudes, so accept_prob within expm1(1e-6 x scale) of itself
    OpSpec("mala_accept", rwm_mala.mala_accept_cuda, rwm_mala.mala_accept_ref,
           "cuda", _I + "mala.py:184", False, 1e-6, relative=True,
           scale=rwm_mala.mala_accept_scale),
    # row 2's kernel over S row shards in one launch: each partial
    # bit-identical to a one-shard launch on its rows; against the plain
    # loop within row 2's bound
    OpSpec("glm_potential_partials", glm_potential.glm_potential_partials_cuda,
           glm_potential.glm_potential_partials_ref, "cuda",
           _K + "glm_potential.py:106", False, 5e-3),
    # row 3's kernel with momentum_sample in front: bit-identical
    OpSpec("chees_open", leapfrog.chees_open_cuda, leapfrog.chees_open_ref,
           "cuda", _K + "leapfrog.py:104", True, 0.0),
    # selections, the running mean, the harmonic mean and the Welford fold
    # bit-identical for the same accept_prob; the sums over D within 1e-6
    # of their terms' magnitudes, so accept_prob within expm1(1e-6 x scale)
    # of itself
    OpSpec("chees_accept", leapfrog.chees_accept_cuda,
           leapfrog.chees_accept_ref, "cuda", _I + "ensemble.py:339", False,
           1e-6, relative=True, scale=leapfrog.chees_accept_scale),
)}


# the public functions of this module that are controls, not ops (the
# registry's bijection, RPL201, leaves them out)
_CONTROL = frozenset({"counters", "launch_counts", "reset_launch_counts"})


def _counted():
    return {**{name: SPECS[name].kernel for name in PORTED},
            **{name: spec.kernel for name, spec in FUSED.items()},
            **{name: spec.kernel for name, spec in BACKWARD.items()}}


def _route(name, tensor):
    """The plain version for a tensor on the CPU, else the kernel."""
    if isinstance(tensor, DTensor):
        raise TypeError(
            f"{name} was given a DTensor: a kernel launches on local "
            "tensors only, through the op's local_map (ops.rmsnorm, "
            "ops.attention, ops.softmax_xent)")
    spec = SPECS.get(name) or BACKWARD.get(name) or FUSED[name]
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
    if isinstance(q, DTensor):
        return _mesh_attention(q, k, v, causal, scale)
    return _flash.FlashAttention.apply(
        q, k, v, causal, scale, _route("attention", q),
        _route("attention_dq", q), _route("attention_dkv", q))[0]


def decode_attention(q, k, v, mask, *, scale=None):
    """Single-query attention against a masked cache (a ref-only op: the
    plain version on every device)."""
    return SPECS["decode_attention"].ref(q, k, v, mask, scale=scale)


def mla_absorbed_decode(q_nope, q_rope, c_kv, k_rope, wk, wv, mask, *,
                        scale):
    """Absorbed-matmul MLA decode against a latent cache ``c_kv (B, S, r)``
    (a ref-only op: the plain version on every device)."""
    return SPECS["mla_absorbed_decode"].ref(q_nope, q_rope, c_kv, k_rope, wk,
                                            wv, mask, scale=scale)


def rmsnorm(x, weight, eps=1e-6):
    """RMSNorm over the last axis, float32 statistics, result in x's dtype;
    differentiable (:class:`~repro_torch.kernels.rmsnorm.RMSNorm`)."""
    if isinstance(x, DTensor):
        return _mesh_rmsnorm(x, weight, eps)
    return _rmsnorm.RMSNorm.apply(x, weight, eps, _route("rmsnorm", x),
                                  _route("rmsnorm_bwd", x))


def softmax_xent(x, w_unembed, labels, *, z_loss_weight=0.0):
    """``x (T, d)``, ``w_unembed (d, V)``, ``labels (T,)`` -> ``(ce,
    z_loss)``, each (T,) float32, without the (T, V) float32 logits kept
    whole; differentiable in ``x`` and ``w_unembed``
    (:class:`~repro_torch.kernels.softmax_xent.SoftmaxXent`: in bfloat16 on
    a card through the dlogits kernel, else the plain backward)."""
    if isinstance(x, DTensor):
        return _mesh_softmax_xent(x, w_unembed, labels, z_loss_weight)
    return _xent.SoftmaxXent.apply(x, w_unembed, labels, z_loss_weight,
                                   _route("softmax_xent", x),
                                   _route("softmax_xent_bwd", x))


# -- the LM ops on a device mesh ------------------------------------------------

def _dense(t):
    """A local shard as the kernels take it: contiguous (a shard of a
    non-leading dim is a strided view), a matrix also as the transpose of
    a contiguous one (a tied unembedding)."""
    if t.is_contiguous() or (t.dim() == 2 and t.T.is_contiguous()):
        return t
    return t.contiguous()


def _mesh_rmsnorm(x, weight, eps):
    """RMSNorm of DTensor ``x``: its rows may stay sharded, the feature dim
    is whole on each rank (a sharded one gathered, a partial sum reduced);
    the weight whole on every rank."""
    mesh = x.device_mesh
    xp = tuple(p if isinstance(p, Shard) and p.dim % x.ndim < x.ndim - 1
               else Replicate() for p in x.placements)
    rep = (Replicate(),) * mesh.ndim
    weight = weight if isinstance(weight, DTensor)         else DTensor.from_local(weight, mesh, rep, run_check=False)
    return local_map(
        lambda xl, wl: _rmsnorm.RMSNorm.apply(
            _dense(xl), _dense(wl), eps, _route("rmsnorm", xl),
            _route("rmsnorm_bwd", xl)),
        out_placements=list(xp), in_placements=(xp, rep),
        in_grad_placements=(xp, grad_placements(mesh, xp)),
        device_mesh=mesh, redistribute_inputs=True)(x, weight)


def _mesh_attention(q, k, v, causal, scale):
    """Attention of DTensors ``q (B, S, H, dq)``, ``k``/``v (B, S, K, d)``:
    the batch stays over the mesh dims that shard it, the heads go over
    the others where they divide, the sequence and head dim are whole.  A
    kv head count a dim does not divide is held whole there (one kv head)
    or repeated to one per query head."""
    mesh = q.device_mesh
    B, _, H, _ = q.shape
    K = k.shape[2]
    qp, kp, heads = [], [], 1
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if n > 1 and isinstance(p, Shard) and p.dim == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif n > 1 and H % (heads * n) == 0:
            heads *= n
            qp.append(Shard(2))
            kp.append(Shard(2) if K % heads == 0 else Replicate())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    if any(a == Shard(2) and b == Replicate() for a, b in zip(qp, kp)) \
            and K > 1:
        # each rank's query heads need their own kv heads: one per head
        k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
        kp = list(qp)
    qp, kp = tuple(qp), tuple(kp)
    kg = tuple(Partial() if a == Shard(2) and b == Replicate() else b
               for a, b in zip(qp, kp))

    def local(ql, kl, vl):
        ql, kl, vl = _dense(ql), _dense(kl), _dense(vl)
        return _flash.FlashAttention.apply(
            ql, kl, vl, causal, scale, _route("attention", ql),
            _route("attention_dq", ql), _route("attention_dkv", ql))[0]
    return local_map(local, out_placements=list(qp), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _mesh_softmax_xent(x, w_unembed, labels, z_loss_weight):
    """``softmax_xent`` of DTensor rows ``x (T, d)``: the rows split over
    every mesh dim of more than one rank that divides them, the unembedding
    gathered whole (vocab and embed dims) on each rank for the fused
    kernel; ``ce`` and ``z_loss`` come back in the rows' layout."""
    mesh = x.device_mesh
    rows, split = x.shape[0], 1
    xp = []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        if n > 1 and rows % (split * n) == 0:
            split *= n
            xp.append(Shard(0))
        else:
            xp.append(Replicate())
    xp = tuple(xp)
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(w_unembed, DTensor):
        w_unembed = DTensor.from_local(w_unembed, mesh, rep, run_check=False)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, rep, run_check=False)

    def local(xl, wl, ll):
        xl, wl, ll = _dense(xl), _dense(wl), _dense(ll)
        return _xent.SoftmaxXent.apply(xl, wl, ll, z_loss_weight,
                                       _route("softmax_xent", xl),
                                       _route("softmax_xent_bwd", xl))
    return local_map(local, out_placements=(list(xp), list(xp)),
                     in_placements=(xp, rep, xp),
                     in_grad_placements=(xp, grad_placements(mesh, xp),
                                         xp),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, w_unembed, labels)


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


def leapfrog_halfstep_batch(z, r, grad, m_inv, eps, kick=0.5, out=None):
    """Chain-batched leapfrog kick + drift over a (C, D) ensemble with a
    shared (D,) ``m_inv``: ``r' = r - (kick * eps) * g``, ``z' = z + eps *
    (r' * m_inv)``; ``kick`` 0.5 is a half-kick, 1.0 the merged kick between
    interior steps; ``eps`` a host number or a one-element device tensor
    -> (z', r'), into ``out = (z_out, r_out)`` when given (it may be ``(z,
    r)``)."""
    return _route("leapfrog_halfstep_batch", z)(z, r, grad, m_inv, eps, kick,
                                                out)


def chees_open(z, n, grad, m_inv, eps, out=None):
    """A ChEES trajectory's opening over a (C, D) ensemble: momenta ``r =
    n / sqrt(m_inv)`` from the standard-normal draw ``n``, then the
    half-kick and drift of :func:`leapfrog_halfstep_batch` -> (z', r'),
    into ``out`` when given (``out[0]`` may be ``z``)."""
    return _route("chees_open", z)(z, n, grad, m_inv, eps, out)


def chees_accept(z0, pe0, g0, n, m_inv, z1, r, pe1, g1, eps, u,
                 max_delta_energy, mean_accept_prob, n_post, h=None,
                 welford=None):
    """The close of a ChEES transition after its trajectory (``z1``, ``r``,
    ``pe1``, ``g1`` before the closing half-kick): the energies, the
    Metropolis test, the selection and the running mean (``n_post > 0``), or
    in warmup (``n_post == 0``) the packed ``[harmonic mean, ChEES
    gradient]`` (``h`` the jitter; None: no gradient) and the Welford fold
    (``welford = (mean, m2, ratio_mean, ratio_m2)``) -> ``(z, pe, grad,
    energy, accept_prob, diverging, mean_accept_prob, stats, (mean,
    m2))``."""
    return _route("chees_accept", z0)(z0, pe0, g0, n, m_inv, z1, r, pe1, g1,
                                      eps, u, max_delta_energy,
                                      mean_accept_prob, n_post, h, welford)


def nuts_leaf(r_half, z, grad, pe, m_inv, eps, r_sum, r_ckpts, r_sum_ckpts,
              ckpt_i=None, idx_min=0, idx_max=-1):
    """One NUTS leaf between two potential evaluations: close the leapfrog
    at ``z`` (``grad``, ``pe`` the potential's there), its kinetic energy,
    the subtree's momentum sum through it, checkpoint row ``ckpt_i`` (an
    even leaf) or the U-turn dots against rows ``idx_min..idx_max`` (an odd
    one), and open the next leapfrog -> ``(r, r_sum_through, [pe, ke,
    dots...], z_next, r_half_next)``; ``eps`` a device scalar."""
    return _route("nuts_leaf", z)(r_half, z, grad, pe, m_inv, eps, r_sum,
                                  r_ckpts, r_sum_ckpts, ckpt_i, idx_min,
                                  idx_max)


def nuts_turning(inverse_mass_matrix, r_left, r_right, r_sum):
    """The two generalized U-turn dots of a tree -> (2,); it turns where
    either is <= 0."""
    return _route("nuts_turning", r_left)(inverse_mass_matrix, r_left,
                                          r_right, r_sum)


def nuts_leaf_batch(r_half, z, grad, pe, m_inv, eps, active, r_sum, r_ckpts,
                    r_sum_ckpts, ckpt_i=None, idx_min=0, idx_max=-1):
    """:func:`nuts_leaf` for C chains in lockstep: (C, D) vectors and
    ``m_inv``, (C,) ``pe``, signed ``eps`` and bool ``active`` (an inactive
    chain is copied through), (C, depth, D) checkpoints, the checkpoint row
    or range shared -> ``(r, r_sum_through, vals (C, 2 + 2 rows), z_next,
    r_half_next)``."""
    return _route("nuts_leaf_batch", z)(r_half, z, grad, pe, m_inv, eps,
                                        active, r_sum, r_ckpts, r_sum_ckpts,
                                        ckpt_i, idx_min, idx_max)


def nuts_turning_batch(inverse_mass_matrix, r_left, r_right, r_sum):
    """The U-turn dots of C trees, (C, D) operands -> (C, 2)."""
    return _route("nuts_turning_batch", r_left)(inverse_mass_matrix, r_left,
                                                r_right, r_sum)


def halfstep_chains(z, r, grad, m_inv, eps, active):
    """:func:`leapfrog_halfstep` for C chains: (C, D) operands, (C,) signed
    ``eps`` and bool ``active`` (an inactive chain is copied through) ->
    (z', r')."""
    return _route("halfstep_chains", z)(z, r, grad, m_inv, eps, active)


def glm_potential_grad(x, y, w, offset=None, scale=None,
                       family="bernoulli_logit"):
    """Fused GLM negative log-likelihood + gradient wrt ``w`` in one pass
    over the (n, d) design matrix: ``w (d,)`` -> (nll scalar, grad (d,)),
    or the chains of an ensemble ``w (C, d)`` -> (nll (C,), grad (C, d)),
    one launch and one read of ``x`` for all C chains on a card."""
    return _route("glm_potential_grad", x)(x, y, w, offset, scale, family)


def glm_potential_partials(x, y, w, offset=None, scale=None,
                           family="bernoulli_logit", *, data_shards=1):
    """Per-shard partials of :func:`glm_potential_grad` over
    ``data_shards`` equal row shards: ``w (d,)`` -> ``((S,), (S, d))``,
    ``w (C, d)`` -> ``((C, S), (C, S, d))``; row ``i`` is
    ``glm_potential_grad`` of shard ``i``.  One launch for every shard and
    chain on a card, the plain loop on the CPU; raises when the rows do not
    split evenly."""
    return _route("glm_potential_partials", x)(
        x, y, w, offset, scale, family, data_shards=data_shards)


def mala_step(z, grad, noise, m_inv, eps):
    """Batched Langevin proposal over a (C, D) ensemble, ``z - eps * m_inv
    * grad + sqrt(2 * eps * m_inv) * noise``; ``grad=None`` gives the
    symmetric random-walk proposal; ``eps`` a host number."""
    return _route("mala_step", z)(z, grad, noise, m_inv, eps)


def mala_accept(z, pe, grad, z_new, pe_new, grad_new, noise, m_inv, u, eps,
                coef, mean_accept_prob, n_post):
    """The Metropolis-Hastings step of every chain after a ``mala_step``
    proposal (MALA's ``grad``/``grad_new``/``noise``, or all ``None`` for
    RWM) -> ``(z, pe, grad, accept_prob, diverging, mean_accept_prob,
    hmean)``; ``n_post`` 0 in warmup (``hmean`` the harmonic-mean accept
    probability), else the post-warmup count of the running mean."""
    return _route("mala_accept", z)(z, pe, grad, z_new, pe_new, grad_new,
                                    noise, m_inv, u, eps, coef,
                                    mean_accept_prob, n_post)


def enum_contract(log_alpha, log_mat):
    """``out[..., j] = logsumexp_i(log_alpha[..., i] + log_mat[..., i, j])``
    over ``(..., Ki) x (..., Ki, K) -> (..., K)``, differentiable: the plain
    versions for CPU tensors, the forward and backward kernels for CUDA
    tensors (:class:`~repro_torch.kernels.enum_contract.EnumContract`)."""
    return _enum_contract.EnumContract.apply(log_alpha, log_mat)


def enum_chain(alpha0, mats):
    """``alpha_T`` of the chain ``alpha_{t+1}[..., j] =
    logsumexp_i(alpha_t[..., i] + mats[t, ..., i, j])`` over ``alpha0 (...,
    K)`` and ``mats (T-1, ..., K, K)`` -> ``(..., K)``; ``alpha0`` for T =
    1.  Differentiable, with one forward and one backward kernel launch per
    chain on a card, the plain chain on the CPU
    (:class:`~repro_torch.kernels.enum_contract.EnumChain`)."""
    return _enum_contract.EnumChain.apply(alpha0, mats)


def enum_chain_alphas(alpha0, mats):
    """Every alpha of the chain of :func:`enum_chain`, ``alphas (T, ...,
    K)`` in ``promote(dtype, float32)``, without autograd: the forward
    filter of ``markov``'s sample mode, one ``enum_chain`` launch on a card
    (none for T = 1), the plain chain on the CPU."""
    with torch.no_grad():
        return _route("enum_chain", alpha0)(alpha0.detach(), mats.detach())


def enum_chain_sample(alphas, mats, gumbel):
    """The backward sample of a chain from its ``alphas (T, ..., K)``, the
    steps' ``mats (T-1, ..., K, K)`` and Gumbel noise ``gumbel (T, ...,
    K)`` -> state indices ``(T, ...)`` int64, ``idx[T-1] = argmax(gumbel[T-1]
    + alphas[T-1])`` and ``idx[t] = argmax(gumbel[t] + (alphas[t] +
    mats[t][..., :, idx[t+1]]))`` below it; one launch on a card, the plain
    version on the CPU."""
    return _route("enum_chain_sample", alphas)(alphas, mats, gumbel)


def counters() -> list:
    """Every launch counter as ``(object, attribute)``: each kernel's
    ``launches`` (``launch_counts``; a stand-in without one has none), the
    GLM kernel's chain evaluations and the random walk's proposals."""
    return [(kernel, "launches") for kernel in _counted().values()
            if hasattr(kernel, "launches")] + [
        (glm_potential.glm_potential_grad_cuda, "chain_evals"),
        (glm_potential.glm_potential_partials_cuda, "chain_evals"),
        (glm_potential.glm_potential_partials_cuda, "shard_evals"),
        (rwm_mala.mala_step_cuda, "launches_without_grad")]


def launch_counts() -> dict:
    """Kernel launches per ported op (and backward kernel) since the last
    reset."""
    return {name: kernel.launches for name, kernel in _counted().items()}


def reset_launch_counts() -> None:
    for kernel in _counted().values():
        kernel.launches = 0
    glm_potential.glm_potential_grad_cuda.chain_evals = 0
    glm_potential.glm_potential_partials_cuda.chain_evals = 0
    glm_potential.glm_potential_partials_cuda.shard_evals = 0
    rwm_mala.mala_step_cuda.launches_without_grad = 0
