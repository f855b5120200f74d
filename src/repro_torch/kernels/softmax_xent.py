"""Blockwise softmax cross-entropy over a large vocab: ``x (T, d)``, an
unembedding ``w (d, V)`` and ``labels (T,)`` give ``ce = lse - x w[:,
label]`` and ``z_loss = z_loss_weight * lse**2`` per row, in float32, with
the float32 ``(T, V)`` logits never kept whole.

- :func:`softmax_xent_ref`: the plain version (``repro/kernels/ref.py:
  softmax_xent``): float32 logits, ``lse - label logit``.
- :func:`softmax_xent_cuda`: ``csrc/softmax_xent.cu``, which streams vocab
  tiles of ``w`` with a running max, sum of exponentials and label logit per
  row.  It reads ``w`` as a contiguous ``(d, V)`` matrix or as the transpose
  of a contiguous ``(V, d)`` one (a tied embedding's ``embed.T``) in place.
- :func:`softmax_xent_bwd`: the gradient, a plain PyTorch recomputation as
  in the JAX package (``softmax_xent.py:93``): ``dlogits = softmax - onehot
  + 2 z_loss_weight lse softmax`` (scaled by the incoming gradients), then
  ``dx`` and ``dw`` with ``torch.matmul``, over chunks of rows so the float32
  ``(T, V)`` never exists whole.
- :class:`SoftmaxXent`: the ``torch.autograd.Function`` that ties them.

All three return ``(ce, z_loss, lse)``; ``ops.softmax_xent`` hands
:class:`SoftmaxXent` the plain version for tensors on the CPU and the kernel
for tensors on a card, and returns ``(ce, z_loss)``.

Differences from the TPU kernel by design: a ragged ``T`` and ``V`` are
masked rather than asserted away (Qwen3's V = 151,936 is not a multiple of
its 512-wide block), and the splits of the vocab are merged in a fixed
order, so every run gives the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "softmax_xent_fwd_f32",
           torch.bfloat16: "softmax_xent_fwd_bf16"}
_ROWS, _COLS = 128, 128   # csrc/softmax_xent.cu: BT, BV
_TARGET_CTAS = 2 * 2 * 132  # two waves of two CTAs on each of 132 SMs
BWD_CHUNK_ELEMENTS = 1 << 27  # float32 (rows, V) of one backward chunk: 512 MB


def softmax_xent_ref(x, w_unembed, labels, z_loss_weight=0.0):
    """The plain version: ``(ce, z_loss, lse)``, each (T,) float32."""
    logits = torch.matmul(x.float(), w_unembed.float())
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - ll, z_loss_weight * lse * lse, lse


def _layout(w):
    """1 for the transpose of a contiguous (V, d) matrix, 0 for a
    contiguous (d, V) one; raises otherwise (a copy of the weight is what
    the kernel is written to avoid).  A dimension of size 1 may have any
    stride; every other stride must be the layout's."""
    d, V = w.shape
    for layout, strides in ((0, (V, 1)), (1, (1, d))):
        if all(n == 1 or s == want
               for n, s, want in zip(w.shape, w.stride(), strides)):
            return layout
    raise ValueError(f"softmax_xent_cuda reads w (d, V) = {tuple(w.shape)} "
                     f"row-major or as the transpose of a row-major (V, d); "
                     f"got strides {w.stride()}")


def softmax_xent_cuda(x, w_unembed, labels, z_loss_weight=0.0):
    """Launch ``csrc/softmax_xent.cu`` on the current stream: one CTA per
    (128-row tile, vocab split), then a kernel that merges the splits.
    ``x`` is a contiguous (T, d) float32 or bfloat16 CUDA tensor, ``w`` (d,
    V) of the same dtype (see :func:`_layout`), ``labels`` (T,) int32 or
    int64 in [0, V) on the same card.  Returns ``(ce, z_loss, lse)``;
    raises on anything else and on a failed build or launch."""
    name = "softmax_xent_cuda"
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} supports float32/bfloat16, got {x.dtype}")
    if x.dim() != 2 or w_unembed.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"{name} takes x (T, d), w (d, V), labels (T,)")
    T, d = x.shape
    V = w_unembed.shape[1]
    if w_unembed.device != x.device or w_unembed.dtype != x.dtype \
            or w_unembed.shape[0] != d:
        raise ValueError(f"{name}: w is {w_unembed.dtype} "
                         f"{tuple(w_unembed.shape)} on {w_unembed.device}; "
                         f"expected {x.dtype} ({d}, V) on {x.device}")
    if labels.device != x.device or labels.shape[0] != T \
            or labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: labels are {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}; "
                         f"expected int ({T},) on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")
    if d == 0 or V == 0:
        raise ValueError(f"{name} needs d > 0 and V > 0, got {d}, {V}")
    vd = _layout(w_unembed)
    # a call captured in a CUDA graph cannot read the labels back: there
    # the kernel gives ce = NaN for a label outside [0, V)
    if T and not torch.cuda.is_current_stream_capturing():
        lo, hi = torch.stack(torch.aminmax(labels)).tolist()
        if lo < 0 or hi >= V:
            raise ValueError(f"{name}: labels must lie in [0, {V}), got "
                             f"[{lo}, {hi}]")
    labels = labels.to(torch.int32).contiguous()
    row_tiles = -(-T // _ROWS)
    vocab_tiles = -(-V // _COLS)
    per = -(-vocab_tiles // min(vocab_tiles,
                                max(1, -(-_TARGET_CTAS // max(row_tiles, 1)))))
    nsplit = -(-vocab_tiles // per)
    fn = getattr(_build.load("softmax_xent"), _DTYPES[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty((3, T), dtype=torch.float32, device=x.device)
    part = torch.empty((3, nsplit, T), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w_unembed.data_ptr(), labels.data_ptr(),
                part.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), T, d, V, vd, nsplit, per,
                float(z_loss_weight), stream)
    if rc != 0:
        raise RuntimeError(f"softmax_xent kernel launch failed: cudaError {rc}")
    softmax_xent_cuda.launches += 1
    return out[0], out[1], out[2]


softmax_xent_cuda.launches = 0


def softmax_xent_bwd(x, w_unembed, labels, lse, g_ce, g_zl, z_loss_weight,
                     chunk_elements=BWD_CHUNK_ELEMENTS):
    """``(dx, dw)`` of ``sum(g_ce * ce + g_zl * z_loss)`` in x's and w's
    dtypes: per chunk of rows, ``dlogits = softmax (g_ce + 2 z_loss_weight
    lse g_zl) - onehot g_ce`` from the float32 logits recomputed with
    ``torch.matmul`` and the saved ``lse``, then ``dx = dlogits w^T`` and
    ``dw += x^T dlogits``."""
    T, d = x.shape
    V = w_unembed.shape[1]
    wf = w_unembed.float()
    dx = torch.empty((T, d), dtype=torch.float32, device=x.device)
    dw = torch.zeros((d, V), dtype=torch.float32, device=x.device)
    coef = g_ce.float() + 2.0 * z_loss_weight * lse * g_zl.float()
    step = max(1, min(T, chunk_elements // max(V, 1)))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        xc = x[t0:t1].float()
        dl = torch.matmul(xc, wf)
        dl.sub_(lse[t0:t1, None]).exp_().mul_(coef[t0:t1, None])
        rows = torch.arange(t1 - t0, device=x.device)
        dl[rows, labels[t0:t1].long()] -= g_ce[t0:t1].float()
        torch.matmul(dl, wf.T, out=dx[t0:t1])
        dw.addmm_(xc.T, dl)
    return dx.to(x.dtype), dw.to(w_unembed.dtype)


class SoftmaxXent(torch.autograd.Function):
    """``apply(x, w, labels, z_loss_weight, fwd) -> (ce, z_loss)``: the
    forward is ``fwd`` (the kernel or the plain version), the backward
    :func:`softmax_xent_bwd` on every device."""

    @staticmethod
    def forward(ctx, x, w_unembed, labels, z_loss_weight, fwd):
        ce, zl, lse = fwd(x, w_unembed, labels, z_loss_weight)
        ctx.save_for_backward(x, w_unembed, labels, lse)
        ctx.z_loss_weight = z_loss_weight
        return ce, zl

    @staticmethod
    def backward(ctx, g_ce, g_zl):
        x, w_unembed, labels, lse = ctx.saved_tensors
        if g_ce is None:
            g_ce = torch.zeros_like(lse)
        if g_zl is None:
            g_zl = torch.zeros_like(lse)
        dx, dw = softmax_xent_bwd(x, w_unembed, labels, lse, g_ce, g_zl,
                                  ctx.z_loss_weight)
        return dx, dw, None, None, None

