"""Attention over a whole sequence (prefill) and against a KV cache (decode).

- :func:`flash_attention_ref` / :func:`flash_attention_cuda`: GQA-aware
  attention ``q (B, S, H, dq), k (B, S, K, dq), v (B, S, K, dv) -> o (B, S,
  H, dv)`` in q's dtype, plus the log-sum-exp of each query's scores ``lse
  (B, H, S)`` in float32 (what the backward pass, still to port, reads).
  Query head ``h`` attends with kv head ``h // (H // K)``.
- :func:`decode_attention_ref`: one query against a masked cache.  The JAX
  package has no TPU kernel for it (a ref-only op), so this plain version is
  its whole port.

``ops.attention`` takes :func:`flash_attention_ref` for tensors on the CPU
and :func:`flash_attention_cuda` (``csrc/flash_attention.cu``) for tensors
on a card; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "flash_attention_fwd_f32",
           torch.bfloat16: "flash_attention_fwd_bf16"}
MAX_HEAD_DIM = 256  # 16 output columns per thread; 214 KB of shared memory


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


def _fn(dtype):
    fn = getattr(_build.load("flash_attention"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, causal=True, scale=None):
    """Launch ``csrc/flash_attention.cu`` on the current stream: one CTA per
    (batch, head, 64-query tile).  Takes contiguous float32 or bfloat16 CUDA
    tensors of one dtype with ``H % K == 0`` and head dims up to 256; raises
    on anything else and on a failed build or launch.  Returns ``(o,
    lse)``."""
    name = "flash_attention_cuda"
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} supports float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes (B, S, heads, dim) operands")
    B, S, H, dq = q.shape
    K, dv = k.shape[2], v.shape[3]
    for label, t, shape in (("k", k, (B, S, K, dq)), ("v", v, (B, S, K, dv))):
        if t.device != q.device or t.dtype != q.dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"{q.dtype} {shape} on {q.device}")
    if K == 0 or H % K:
        raise ValueError(f"{name}: {H} query heads do not group over {K} "
                         "kv heads")
    if not (0 < dq <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM):
        raise ValueError(f"{name} takes head dims up to {MAX_HEAD_DIM}, got "
                         f"dq={dq}, dv={dv}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name} needs contiguous tensors")
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
