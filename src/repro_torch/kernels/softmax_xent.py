"""Blockwise softmax cross-entropy over a large vocab: ``x (T, d)``, an
unembedding ``w (d, V)`` and ``labels (T,)`` give ``ce = lse - x w[:,
label]`` and ``z_loss = z_loss_weight * lse**2`` per row, in float32, with
the float32 ``(T, V)`` logits never kept whole.

- :func:`softmax_xent_ref`: the plain version (``repro/kernels/ref.py:
  softmax_xent``): float32 logits, ``lse - label logit``.
- :func:`softmax_xent_cuda`: ``csrc/softmax_xent.cu``, which streams vocab
  tiles of ``w`` with a running max, sum of exponentials and label logit per
  row (float32 on the CUDA cores, bfloat16 on the tensor cores).  It reads
  ``w`` as a contiguous ``(d, V)`` matrix or as the transpose of a
  contiguous ``(V, d)`` one (a tied embedding's ``embed.T``) in place.
- :func:`softmax_xent_bwd`: the plain gradient, a PyTorch recomputation as
  in the JAX package (``softmax_xent.py:93``): ``dlogits = softmax - onehot
  + 2 z_loss_weight lse softmax`` (scaled by the incoming gradients), then
  ``dx`` and ``dw`` with float32 ``torch.matmul``, over chunks of rows so
  the float32 ``(T, V)`` never exists whole.
- :func:`softmax_xent_bwd_cuda`: the bfloat16 gradient on a card: the
  ``csrc/softmax_xent.cu`` dlogits kernel recomputes the logits on the
  tensor cores and writes ``dlogits`` as a bf16 hi + lo pair, then ``dx``
  and ``dw`` are bf16 products with float32 outputs (cuBLAS, as the JAX
  package leaves them to XLA), rounded once to bf16.
- :class:`SoftmaxXent`: the ``torch.autograd.Function`` that ties them.

The forwards return ``(ce, z_loss, lse)``; ``ops.softmax_xent`` hands
:class:`SoftmaxXent` the plain versions for tensors on the CPU and the
kernels for tensors on a card, and returns ``(ce, z_loss)``.  The float32
backward is the plain version on every device.

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
_ROWS, _COLS = 128, 128   # csrc/softmax_xent.cu: BT, BV of the float32 kernel
_TARGET_CTAS = 2 * 2 * 132  # two waves of two CTAs on each of 132 SMs
# (rows, V) of one chunk of the plain backward: its float32 dlogits, 512 MB
BWD_CHUNK_ELEMENTS = 1 << 27
# (rows, V) of one chunk of the bf16 backward: its bf16 [hi; lo] dlogits,
# 2 GiB (gemma-2b's 2048-row microbatch against V = 256,000 is one chunk)
TC_BWD_CHUNK_ELEMENTS = 1 << 29
# The depth of each bf16 product with a float32 output in the bf16
# backward: dx's products over the vocab are cut into slices this deep, and
# a chunk has at most half as many rows (dw's product is over 2 x rows).
# The tensor cores round their float32 accumulator toward zero, so an
# error grows with a product's depth: dx at V = 151,936 in one product
# missed the one-step bf16 gate; each slice's result is added in float32.
TC_DEPTH = 4096
_PLANS = {}  # (dlogits, T, V, layout, device) -> (nsplit, tiles per split)


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


def _operands(name, x, w_unembed, labels):
    """Check the kernels' operands; returns ``(T, d, V, layout, labels as
    contiguous int32)``."""
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
    # the kernels give ce = NaN (and a NaN dlogits row) for a label outside
    # [0, V)
    if T and not torch.cuda.is_current_stream_capturing():
        lo, hi = torch.stack(torch.aminmax(labels)).tolist()
        if lo < 0 or hi >= V:
            raise ValueError(f"{name}: labels must lie in [0, {V}), got "
                             f"[{lo}, {hi}]")
    return T, d, V, vd, labels.to(torch.int32).contiguous()


def _plan(lib, dlogits, T, V, vd, device):
    """``(nsplit, tiles per split)`` of a bf16 call: two waves of the CTAs
    the card holds at once (``softmax_xent_bf16_plan``), cached."""
    key = (dlogits, T, V, vd, device.index)
    if key not in _PLANS:
        fn = lib.softmax_xent_bf16_plan
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        nsplit, per = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(device):
            rc = fn(dlogits, T, V, vd, ctypes.byref(nsplit),
                    ctypes.byref(per))
        if rc != 0:
            raise RuntimeError(f"softmax_xent_bf16_plan failed: cudaError "
                               f"{rc}")
        _PLANS[key] = (nsplit.value, per.value)
    return _PLANS[key]


def softmax_xent_cuda(x, w_unembed, labels, z_loss_weight=0.0):
    """Launch ``csrc/softmax_xent.cu`` on the current stream: one CTA per
    (128-row tile, vocab split), then a kernel that merges the splits.
    ``x`` is a contiguous (T, d) float32 or bfloat16 CUDA tensor, ``w`` (d,
    V) of the same dtype (see :func:`_layout`), ``labels`` (T,) int32 or
    int64 in [0, V) on the same card.  Returns ``(ce, z_loss, lse)``;
    raises on anything else and on a failed build or launch."""
    T, d, V, vd, labels = _operands("softmax_xent_cuda", x, w_unembed, labels)
    lib = _build.load("softmax_xent")
    if x.dtype == torch.bfloat16:
        nsplit, per = _plan(lib, 0, T, V, vd, x.device)
    else:
        row_tiles = -(-T // _ROWS)
        vocab_tiles = -(-V // _COLS)
        per = -(-vocab_tiles // min(
            vocab_tiles, max(1, -(-_TARGET_CTAS // max(row_tiles, 1)))))
        nsplit = -(-vocab_tiles // per)
    fn = getattr(lib, _DTYPES[x.dtype])
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
    """The plain backward: ``(dx, dw)`` of ``sum(g_ce * ce + g_zl *
    z_loss)`` in x's and w's dtypes: per chunk of rows, ``dlogits = softmax
    (g_ce + 2 z_loss_weight lse g_zl) - onehot g_ce`` from the float32
    logits recomputed with ``torch.matmul`` and the saved ``lse``, then ``dx
    = dlogits w^T`` and ``dw += x^T dlogits``."""
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


def softmax_xent_bwd_cuda(x, w_unembed, labels, lse, g_ce, g_zl,
                          z_loss_weight, chunk_elements=TC_BWD_CHUNK_ELEMENTS):
    """The bfloat16 backward on a card, over chunks of rows: the dlogits
    kernel writes the chunk's ``dlogits`` as bf16 ``[hi; lo]`` (2 rows, V);
    then ``dx = hi w^T + lo w^T`` (over ``TC_DEPTH``-deep vocab slices) and
    ``dw += [x; x]^T [hi; lo]`` are bf16 products with float32 outputs, so
    each of dx and dw is summed in float32 and rounded once to bf16.
    Operands as for :func:`softmax_xent_cuda` (bfloat16 only), ``lse``,
    ``g_ce``, ``g_zl`` (T,).  ``dw`` comes back in ``w``'s layout.  Raises
    on anything else and on a failed build or launch."""
    name = "softmax_xent_bwd_cuda"
    T, d, V, vd, labels = _operands(name, x, w_unembed, labels)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bfloat16 (float32 takes the plain "
                        f"softmax_xent_bwd), got {x.dtype}")
    for vec in (lse, g_ce, g_zl):
        if vec.shape != (T,) or vec.device != x.device:
            raise ValueError(f"{name}: lse, g_ce and g_zl must be ({T},) on "
                             f"{x.device}, got {tuple(vec.shape)} on "
                             f"{vec.device}")
    lse = lse.float().contiguous()
    gce = g_ce.float().contiguous()
    coef = (gce + 2.0 * z_loss_weight * lse * g_zl.float()).contiguous()
    if T == 0:
        return torch.zeros_like(x), torch.zeros_like(w_unembed)
    lib = _build.load("softmax_xent")
    fn = lib.softmax_xent_dlogits_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    step = max(1, min(T, chunk_elements // V, TC_DEPTH // 2))
    buf = torch.empty((2 * step, V), dtype=torch.bfloat16, device=x.device)
    wt = w_unembed.T  # (V, d), either layout in place
    dx = torch.empty((T, d), dtype=torch.float32, device=x.device)
    dw = None
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        rows = t1 - t0
        nsplit, per = _plan(lib, 1, rows, V, vd, x.device)
        with torch.cuda.device(x.device):
            rc = fn(x[t0:t1].data_ptr(), w_unembed.data_ptr(),
                    labels[t0:t1].data_ptr(), lse[t0:t1].data_ptr(),
                    coef[t0:t1].data_ptr(), gce[t0:t1].data_ptr(),
                    buf.data_ptr(), rows, d, V, vd, nsplit, per, stream)
        if rc != 0:
            raise RuntimeError(f"softmax_xent dlogits kernel launch failed: "
                               f"cudaError {rc}")
        softmax_xent_bwd_cuda.launches += 1
        dl = buf[:2 * rows]
        acc = None
        for v0 in range(0, V, TC_DEPTH):
            for half in (dl[:rows], dl[rows:]):
                a, b = half[:, v0:v0 + TC_DEPTH], wt[v0:v0 + TC_DEPTH]
                acc = (torch.mm(a, b, out_dtype=torch.float32) if acc is None
                       else torch.addmm(acc, a, b, out_dtype=torch.float32))
        dx[t0:t1] = acc
        xx = x[t0:t1].repeat(2, 1)
        part = (torch.mm(dl.T, xx, out_dtype=torch.float32) if vd
                else torch.mm(xx.T, dl, out_dtype=torch.float32))
        dw = part if dw is None else dw.add_(part)
        del dl, acc, xx, part
    del buf
    dw = dw.to(w_unembed.dtype)
    return dx.to(x.dtype), (dw.T if vd else dw)


softmax_xent_bwd_cuda.launches = 0


class SoftmaxXent(torch.autograd.Function):
    """``apply(x, w, labels, z_loss_weight, fwd, bwd) -> (ce, z_loss)``: the
    forward is ``fwd`` (the kernel or the plain version); the backward is
    ``bwd`` for bfloat16 operands (:func:`softmax_xent_bwd_cuda` on a card,
    the plain version on the CPU) and :func:`softmax_xent_bwd` for
    float32 ones on every device."""

    @staticmethod
    def forward(ctx, x, w_unembed, labels, z_loss_weight, fwd, bwd):
        ce, zl, lse = fwd(x, w_unembed, labels, z_loss_weight)
        ctx.save_for_backward(x, w_unembed, labels, lse)
        ctx.z_loss_weight = z_loss_weight
        ctx.bwd = bwd if x.dtype == torch.bfloat16 else softmax_xent_bwd
        return ce, zl

    @staticmethod
    def backward(ctx, g_ce, g_zl):
        x, w_unembed, labels, lse = ctx.saved_tensors
        if g_ce is None:
            g_ce = torch.zeros_like(lse)
        if g_zl is None:
            g_zl = torch.zeros_like(lse)
        dx, dw = ctx.bwd(x, w_unembed, labels, lse, g_ce, g_zl,
                         ctx.z_loss_weight)
        return dx, dw, None, None, None, None

