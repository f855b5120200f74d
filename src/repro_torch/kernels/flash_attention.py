"""Attention over a whole sequence (prefill) and against a KV cache (decode).

- :func:`flash_attention_ref` / :func:`flash_attention_cuda`: GQA-aware
  attention ``q (B, S, H, dq), k (B, S, K, dq), v (B, S, K, dv) -> o (B, S,
  H, dv)`` in q's dtype, plus the log-sum-exp of each query's scores ``lse
  (B, H, S)`` in float32 (what the backward reads).  Query head ``h``
  attends with kv head ``h // (H // K)``.
- The backward, the flash-2 recomputation from the saved ``lse`` with
  ``delta = sum(dO * o)``, in two passes as the JAX package's
  ``_flash_bwd``: :func:`flash_attention_dq_ref` /
  :func:`flash_attention_dq_cuda` give ``(dq, delta)``,
  :func:`flash_attention_dkv_ref` / :func:`flash_attention_dkv_cuda` give
  ``(dk, dv)`` summed over each kv head's query heads
  (``csrc/flash_attention_bwd.cu``); :func:`flash_attention_bwd_ref` is
  the two plain passes together.
- :class:`FlashAttention`: the ``torch.autograd.Function`` that ties them;
  it saves ``q, k, v, o, lse``.
- :func:`decode_attention_ref`: one query against a masked cache.  The JAX
  package has no TPU kernel for it (a ref-only op), so this plain version is
  its whole port.

``ops.attention`` hands :class:`FlashAttention` the plain versions for
tensors on the CPU and the kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) for tensors on a card; it never falls back
from one to the other.  On the card the dtype picks the kernel: the
bfloat16 forward, dq and dkv passes run on the tensor cores (``mma.sync``
bf16 -> f32, the float32 P and dS fed as a bf16 hi and lo part, so they
compute the float32 function to one bf16 step); float32 ones on the CUDA
cores in float32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "flash_attention_fwd_f32",
           torch.bfloat16: "flash_attention_fwd_bf16"}
_DQ = {torch.float32: "flash_attention_dq_f32",
       torch.bfloat16: "flash_attention_dq_bf16"}
_DKV = {torch.float32: "flash_attention_dkv_f32",
        torch.bfloat16: "flash_attention_dkv_bf16"}
MAX_HEAD_DIM = 256  # every kernel holds a row's output columns on chip


def _scores(q, k, scale):
    """float32 scores (B, K, G, S_q, S_k) of the grouped heads."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, dq)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale


def flash_attention_ref(q, k, v, causal=True, scale=None, window=0):
    """The plain PyTorch version (``repro/kernels/ref.py:attention``):
    softmax in float32, ``window > 0`` the sliding window of the last
    ``window`` positions (causal only).  Returns ``(o, lse)``."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    scale = dq ** -0.5 if scale is None else scale
    scores = _scores(q, k, scale)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = j <= i
        if window:
            mask = mask & (j > i - window)
        scores = scores.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)               # (B, K, G, S)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    o = out.reshape(B, S, H, v.shape[-1]).to(q.dtype)
    return o, lse.reshape(B, H, S)


def decode_attention_ref(q, k, v, mask, scale=None):
    """Single-query attention against a full cache
    (``repro/kernels/ref.py:decode_attention``): ``q (B, 1, H, dq)``, ``k
    (B, S, K, dq)``, ``v (B, S, K, dv)``, ``mask (1|B, S)`` bool ->
    ``(B, 1, H, dv)`` in q's dtype."""
    B, _, H, dq = q.shape
    K = k.shape[2]
    scale = dq ** -0.5 if scale is None else scale
    qg = q.reshape(B, K, H // K, dq)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def mla_absorbed_decode_ref(q_nope, q_rope, c_kv, k_rope, wk, wv, mask, *,
                            scale):
    """Absorbed-matmul MLA decode, never expanding k or v
    (``repro/kernels/ref.py:mla_absorbed_decode``): ``q_nope (B, 1, H,
    dn)``, ``q_rope (B, 1, H, dr)``, the latent cache ``c_kv (B, S, r)``,
    ``k_rope (B, S, dr)``, the expansions ``wk (H, dn, r)`` and ``wv (H, r,
    dv)``, ``mask (1|B, S)`` bool -> ``(B, 1, H, dv)`` in q_nope's dtype;
    float32 throughout."""
    ql = torch.einsum("bqhn,hnr->bqhr", q_nope.float(), wk.float())
    s_lat = torch.einsum("bqhr,bsr->bhqs", ql, c_kv.float())
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) * scale
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsr->bqhr", p, c_kv.float())
    out = torch.einsum("bqhr,hrv->bqhv", o_lat, wv.float())
    return out.to(q_nope.dtype)


def _fn(dtype):
    fn = getattr(_build.load("flash_attention"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, q, k, v, **rest):
    """Device, dtype, shape and contiguity of the operands: ``q, k, v`` and
    the backward's ``o``/``do`` (B, S, H, dv) and ``lse``/``delta`` (B, H,
    S) float32, where given.  Returns (B, S, H, dq)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} supports float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes (B, S, heads, dim) operands")
    B, S, H, dq = q.shape
    K, dv = k.shape[2], v.shape[3]
    expected = {"k": ((B, S, K, dq), q.dtype), "v": ((B, S, K, dv), q.dtype),
                "o": ((B, S, H, dv), q.dtype), "do": ((B, S, H, dv), q.dtype),
                "lse": ((B, H, S), torch.float32),
                "delta": ((B, H, S), torch.float32)}
    for label, t in (("k", k), ("v", v), *rest.items()):
        shape, dtype = expected[label]
        if t.device != q.device or t.dtype != dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"{dtype} {shape} on {q.device}")
    if K == 0 or H % K:
        raise ValueError(f"{name}: {H} query heads do not group over {K} "
                         "kv heads")
    if not (0 < dq <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"{name} takes head dims up to {MAX_HEAD_DIM}, got "
                         f"dq={dq}, dv={dv}")
    if not all(t.is_contiguous() for t in (q, k, v, *rest.values())):
        raise ValueError(f"{name} needs contiguous tensors")
    return B, S, H, dq


def flash_attention_cuda(q, k, v, causal=True, scale=None, window=0):
    """Launch ``csrc/flash_attention.cu`` on the current stream: one CTA per
    (head, batch, query tile), on the tensor cores for bfloat16 and the CUDA
    cores for float32.  Takes contiguous float32 or bfloat16 CUDA
    tensors of one dtype with ``H % K == 0`` and head dims up to 256; raises
    on anything else and on a failed build or launch.  Returns ``(o,
    lse)``.  ``window`` is the plain version's parameter and must be 0: the
    kernel has no sliding window (``ops.attention`` sends ``window > 0`` to
    the plain version, as the JAX package's ``flash_attention`` does)."""
    if window:
        raise ValueError("flash_attention_cuda has no sliding window: got "
                         f"window={window}; ops.attention runs window > 0 "
                         "through the plain version")
    B, S, H, dq = _check("flash_attention_cuda", q, k, v)
    K, dv = k.shape[2], v.shape[3]
    fn = _fn(q.dtype)
    scale = dq ** -0.5 if scale is None else float(scale)
    o = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), B, S, H, K, dq, dv, scale,
                int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_cuda.launches += 1
    return o, lse


flash_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _delta(o, do):
    """``delta[b, h, s] = sum_c dO[b, s, h, c] o[b, s, h, c]`` in float32."""
    return torch.einsum("bshd,bshd->bhs", do.float(), o.float())


def _probs_and_ds(q, k, v, lse, delta, do, causal, scale):
    """float32 ``p`` and ``ds`` (B, K, G, S_q, S_k) of the flash-2
    recomputation: ``p = exp(s - lse)`` (0 where masked), ``ds = p (dO v -
    delta) scale``."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    G = H // K
    scores = _scores(q, k, scale)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        scores = scores.masked_fill(j > i, float("-inf"))
    p = torch.exp(scores - lse.reshape(B, K, G, S)[..., None])
    dog = do.reshape(B, S, K, G, do.shape[-1]).float()
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.float())
    ds = p * (dp - delta.reshape(B, K, G, S)[..., None]) * scale
    return p, ds


def flash_attention_dq_ref(q, k, v, o, lse, do, causal=True, scale=None):
    """The plain dq pass (``repro/kernels/flash_attention.py:_dq_kernel``
    over all tiles): ``(dq in q's dtype, delta (B, H, S) float32)``."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    scale = dq ** -0.5 if scale is None else scale
    delta = _delta(o, do)
    _, ds = _probs_and_ds(q, k, v, lse, delta, do, causal, scale)
    dqv = torch.einsum("bkgst,btkd->bskgd", ds, k.float())
    return dqv.reshape(B, S, H, dq).to(q.dtype), delta


def flash_attention_dkv_ref(q, k, v, lse, delta, do, causal=True,
                            scale=None):
    """The plain dkv pass (``_dkv_kernel`` over all tiles, the G query heads
    of each kv head summed): ``(dk, dv)`` in k's and v's dtypes."""
    B, S, H, dq = q.shape
    K = k.shape[2]
    scale = dq ** -0.5 if scale is None else scale
    p, ds = _probs_and_ds(q, k, v, lse, delta, do, causal, scale)
    qg = q.reshape(B, S, K, H // K, dq).float()
    dog = do.reshape(B, S, K, H // K, do.shape[-1]).float()
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    dvv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dk.to(k.dtype), dvv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, scale=None):
    """Both plain passes: ``(dq, dk, dv)``."""
    dq, delta = flash_attention_dq_ref(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_attention_dkv_ref(q, k, v, lse, delta, do, causal, scale)
    return dq, dk, dv


def _bwd_fn(table, dtype, nptr):
    fn = getattr(_build.load("flash_attention_bwd"), table[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_dq_cuda(q, k, v, o, lse, do, causal=True, scale=None):
    """Launch the dq pass of ``csrc/flash_attention_bwd.cu`` (a delta
    kernel, then one CTA per (head, batch, 64-query tile), on the tensor
    cores for bfloat16 and the CUDA cores for float32).  ``o`` and
    ``do`` are (B, S, H, dv) of q's dtype, ``lse`` (B, H, S) float32, all
    contiguous on one card.  Returns ``(dq, delta)``; raises on anything
    else and on a failed build or launch."""
    B, S, H, dq = _check("flash_attention_dq_cuda", q, k, v, o=o, do=do,
                         lse=lse)
    K, dv = k.shape[2], v.shape[3]
    scale = dq ** -0.5 if scale is None else float(scale)
    dqt = torch.empty_like(q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _bwd_fn(_DQ, q.dtype, 8)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqt.data_ptr(),
            B, S, H, K, dq, dv, scale, int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention dq kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_dq_cuda.launches += 1
    return dqt, delta


flash_attention_dq_cuda.launches = 0


def flash_attention_dkv_cuda(q, k, v, lse, delta, do, causal=True,
                             scale=None):
    """Launch the dkv pass of ``csrc/flash_attention_bwd.cu``: one CTA per
    (batch, query head, 64-key tile) writes the head's float32 partials (on
    the tensor cores for bfloat16, the CUDA cores for float32), then the G
    heads of each kv head are summed in order and rounded once.
    ``lse`` and ``delta`` are (B, H, S) float32.  Returns ``(dk, dv)``;
    raises on a bad operand and on a failed build or launch."""
    B, S, H, dq = _check("flash_attention_dkv_cuda", q, k, v, do=do, lse=lse,
                         delta=delta)
    K, dv = k.shape[2], v.shape[3]
    scale = dq ** -0.5 if scale is None else float(scale)
    dk_h = torch.empty((B, S, H, dq), dtype=torch.float32, device=q.device)
    dv_h = torch.empty((B, S, H, dv), dtype=torch.float32, device=q.device)
    dkt, dvt = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _bwd_fn(_DKV, q.dtype, 10)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk_h.data_ptr(),
            dv_h.data_ptr(), dkt.data_ptr(), dvt.data_ptr(), B, S, H, K, dq,
            dv, scale, int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention dkv kernel launch failed: "
                           f"cudaError {rc}")
    flash_attention_dkv_cuda.launches += 1
    return dkt, dvt


flash_attention_dkv_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: ``apply(q, k, v, causal, scale, fwd,
    dq_fn, dkv_fn)`` runs ``fwd`` (returning ``(o, lse)``) and, in the
    backward, ``dq_fn`` then ``dkv_fn`` (``ops.attention`` picks kernels or
    plain versions by device).  Saves ``q, k, v, o, lse``; returns ``o``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, fwd, dq_fn, dkv_fn):
        o, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.dq_fn, ctx.dkv_fn = dq_fn, dkv_fn
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = ctx.dq_fn(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        dk, dv = ctx.dkv_fn(q, k, v, lse, delta, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None, None
