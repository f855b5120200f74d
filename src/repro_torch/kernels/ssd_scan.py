"""The Mamba-2 SSD (state-space duality) chunked scan and its one-token
decode update.

- :func:`ssd_scan_ref` / :func:`ssd_scan_cuda`: ``x (b, l, h, p)``, ``dt (b,
  l, h)``, ``A (h,)``, ``B, C (b, l, g, n)`` -> ``(y (b, l, h, p)`` in x's
  dtype, ``final state (b, h, p, n)`` float32), with an optional skip
  ``D (h,)`` and entering state ``h0 (b, h, p, n)``; head ``h`` reads the
  B/C group ``h // (heads / g)``.  The plain version (``repro/kernels/
  ref.py:ssd_scan``) and ``csrc/ssd_scan.cu``.
- :class:`SsdScan`: the ``torch.autograd.Function`` that runs the forward it
  is handed and, in the backward, autograd through the plain version
  recomputed from the saved inputs (what the JAX package's ``custom_vjp``
  does, ``repro/kernels/ssd_scan.py:_ssd_b``; it has no backward kernel).
- :func:`ssd_decode_step_ref`: one token's state update (``ref.py:
  ssd_decode_step``).  The JAX package has no TPU kernel for it (a ref-only
  op), so this plain version is its whole port.

The sequence length must be a whole number of chunks on every device, as
the reference asserts.  ``ops.ssd_scan`` hands :class:`SsdScan` the plain
version for tensors on the CPU and the kernel for tensors on a card; it
never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
MAX_CHUNK = 256  # csrc/ssd_scan.cu: the chunk's dt and cum in shared memory
MAX_STATE = 256  # csrc/ssd_scan.cu: n, the width of its shared-memory tiles


def check_chunk(l, chunk):
    """The reference's ``assert l % chunk == 0`` (``ref.py:75``), as an
    error on every device."""
    if chunk <= 0 or l % chunk:
        raise ValueError(f"ssd_scan: the sequence length {l} is not a whole "
                         f"number of chunks of {chunk}")


def _causal_decay(cum):
    """``exp(cum_i - cum_j)`` for ``i >= j`` and 0 above the diagonal, over
    the chunk axes (-3, -2) of ``cum[..., c, h]`` broadcast as (..., c, c,
    h).  The difference is masked before ``exp``: above the diagonal it is
    positive and can overflow, and ``0 * inf`` would then poison the
    gradient (the reference's ``where(causal, exp(seg), 0)`` does)."""
    seg = cum[..., :, None, :] - cum[..., None, :, :]
    c = cum.shape[-2]
    causal = torch.ones(c, c, dtype=torch.bool, device=cum.device).tril()
    return torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))


def ssd_scan_ref(x, dt, A, B, C, *, chunk, D=None, h0=None):
    """The plain PyTorch version (``repro/kernels/ref.py:ssd_scan``): the
    intra-chunk quadratic part, the chunk states and their inter-chunk
    recurrence, the entering states' contribution, all in float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    check_chunk(l, chunk)
    nc, rep = l // chunk, h // g
    xc = x.float().reshape(b, nc, chunk, h, p)
    dtc = dt.float().reshape(b, nc, chunk, h)
    Bc = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Cc = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    cum = torch.cumsum(dtc * A.float(), dim=2)          # (b, nc, c, h)

    scores = torch.einsum("bzihn,bzjhn->bzijh", Cc, Bc) * _causal_decay(cum)
    y_diag = torch.einsum("bzijh,bzjh,bzjhp->bzihp", scores, dtc, xc)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (b, nc, c, h)
    states = torch.einsum("bzch,bzch,bzchn,bzchp->bzhpn", dtc, decay_to_end,
                          Bc, xc)                       # (b, nc, h, p, n)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (b, nc, h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    prev = []
    for z in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)              # (b, nc, h, p, n)
    y_off = torch.einsum("bzchn,bzhpn,bzch->bzchp", Cc, prev_states,
                         torch.exp(cum))
    y = (y_diag + y_off).reshape(b, l, h, p)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), s


def ssd_decode_step_ref(state, x, dt, A, B, C, *, D=None):
    """One token (``ref.py:ssd_decode_step``): ``state (b, h, p, n)``, ``x
    (b, h, p)``, ``dt (b, h)``, ``B, C (b, g, n)`` -> ``(y (b, h, p)`` in
    x's dtype, ``new state`` float32)."""
    h, g = x.shape[1], B.shape[1]
    rep = h // g
    Bh = B.float().repeat_interleave(rep, dim=1)
    Ch = C.float().repeat_interleave(rep, dim=1)
    xf, dtf = x.float(), dt.float()
    dA = torch.exp(dtf * A.float())                     # (b, h)
    new = state * dA[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn",
                                                     dtf, xf, Bh)
    y = torch.einsum("bhpn,bhn->bhp", new, Ch)
    if D is not None:
        y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), new


def _fn(dtype):
    fn = getattr(_build.load("ssd_scan"), _DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _rows_packed(t):
    """The last two dims are packed (a row of ``heads x width`` is
    contiguous); the batch and sequence strides are free."""
    return t.stride(3) == 1 and (t.shape[2] == 1
                                 or t.stride(2) == t.shape[3])


def _check(x, dt, A, B, C, chunk, D, h0):
    """Device, dtype, shape and layout of the operands; returns (b, l, h,
    p, g, n)."""
    name = "ssd_scan_cuda"
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} supports float32/bfloat16, got {x.dtype}")
    if x.dim() != 4 or B.dim() != 4 or C.dim() != 4:
        raise ValueError(f"{name} takes x (b, l, h, p) and B, C (b, l, g, n)")
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    expected = {"dt": ((b, l, h), torch.float32), "A": ((h,), torch.float32),
                "B": ((b, l, g, n), x.dtype), "C": ((b, l, g, n), x.dtype),
                "D": ((h,), torch.float32), "h0": ((b, h, p, n),
                                                   torch.float32)}
    for label, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D),
                     ("h0", h0)):
        if t is None:
            continue
        shape, dtype = expected[label]
        if t.device != x.device or t.dtype != dtype \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"{dtype} {shape} on {x.device}")
    check_chunk(l, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name} takes chunks up to {MAX_CHUNK}, got {chunk}")
    if g == 0 or h % g:
        raise ValueError(f"{name}: {h} heads do not group over {g} B/C groups")
    if not 0 < n <= MAX_STATE or p <= 0:
        raise ValueError(f"{name} takes a state of 1 to {MAX_STATE} columns "
                         f"and p > 0, got n={n}, p={p}")
    if not all(_rows_packed(t) for t in (x, B, C)):
        raise ValueError(f"{name} needs x, B and C with packed (heads, width) "
                         "rows")
    if not all(t.is_contiguous() for t in (dt, A, D, h0) if t is not None):
        raise ValueError(f"{name} needs contiguous dt, A, D and h0")
    return b, l, h, p, g, n


def ssd_scan_cuda(x, dt, A, B, C, *, chunk, D=None, h0=None):
    """Launch ``csrc/ssd_scan.cu`` on the current stream: one CTA per
    (batch, head, block of the head's p channels), the chunks in order
    inside it; bfloat16 runs ``ssd_tc_kernel`` on the tensor cores (64
    channels a CTA), float32 ``ssd_scan_kernel`` on the CUDA cores (32).  ``x``, ``B``, ``C`` float32 or
    bfloat16 of one dtype, each with
    packed (heads, width) rows (slices of a wider projection are read in
    place); ``dt``, ``A``, ``D``, ``h0`` contiguous float32.  Raises on
    anything else, on a ragged length and on a failed build or launch.
    Returns ``(y, state)``."""
    b, l, h, p, g, n = _check(x, dt, A, B, C, chunk, D, h0)
    fn = _fn(x.dtype)
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), None if D is None else D.data_ptr(),
                None if h0 is None else h0.data_ptr(), y.data_ptr(),
                state.data_ptr(), b, l, h, p, g, n, chunk,
                x.stride(0), x.stride(1), B.stride(0), B.stride(1),
                C.stride(0), C.stride(1), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0


class SsdScan(torch.autograd.Function):
    """The SSD scan with its gradient: ``apply(x, dt, A, B, C, D, h0, chunk,
    fwd)`` runs ``fwd`` (``ops.ssd_scan`` picks the kernel or the plain
    version by device) and returns ``(y, state)``; the backward recomputes
    the plain version from the saved inputs under autograd, so it is the
    plain version's gradient on every device, ``h0``'s included."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk, fwd):
        ctx.save_for_backward(x, dt, A, B, C, D, h0)
        ctx.chunk = chunk
        return fwd(x, dt, A, B, C, chunk=chunk, D=D, h0=h0)

    @staticmethod
    def backward(ctx, gy, gst):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, needs)]
            x, dt, A, B, C, D, h0 = inputs
            y, st = ssd_scan_ref(x, dt, A, B, C, chunk=ctx.chunk, D=D, h0=h0)
            wrt = [t for t, need in zip(inputs, needs) if need]
            # an output none of the needed inputs reach is left out (the
            # state when only D needs a gradient)
            outs = [(o, g) for o, g in ((y, gy), (st, gst)) if o.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wrt, [g for _, g in outs],
                allow_unused=True) if wrt else ())
        return (*(next(grads) if need else None for need in needs), None,
                None)
