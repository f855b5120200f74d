"""Fused GLM potential and gradient (the logreg / CoverType hot path).

``glm_potential_grad(x, y, w, offset, scale, family)`` returns the negative
log-likelihood of a GLM with linear predictor ``l = x @ w + offset`` and its
gradient with respect to ``w``:

- ``bernoulli_logit``: ``nll_i = softplus(l_i) - y_i * l_i`` (the exact
  negation of ``Bernoulli.log_prob``), gradient ``x^T (sigmoid(l) - y)``;
- ``normal``: ``nll_i = 0.5 ((l_i - y_i)/scale)^2 + log scale +
  0.5 log 2 pi``, gradient ``x^T (l - y) / scale^2``.

Both reduce the same residual against the same rows of ``x``, so the CUDA
kernel (``csrc/glm_potential.cu``) reads ``x`` once for value and gradient.
``ops.glm_potential_grad`` takes :func:`glm_potential_grad_ref` for CPU
tensors and :func:`glm_potential_grad_cuda` for CUDA tensors, never the
other.  The per-shard partials
(``glm_potential_partials``) wait for the data-shards slice.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_FAMILIES = {"bernoulli_logit": 0, "normal": 1}
MAX_D = 256  # the kernel keeps w in registers: at most 8 columns per lane


def glm_potential_grad_ref(x, y, w, offset=None, scale=None,
                           family="bernoulli_logit", *,
                           compute_dtype=torch.float32):
    """The plain PyTorch version (port of ``repro.kernels.ref.
    glm_potential_grad``): computes in float32 like the kernel, or in
    ``compute_dtype`` where it referees the kernel; returns ``w.dtype``."""
    xf = x.to(compute_dtype)
    yf = y.to(compute_dtype)
    logits = xf @ w.to(compute_dtype)
    if offset is not None:
        logits = logits + offset.to(compute_dtype)
    if family == "bernoulli_logit":
        nll = torch.sum(F.softplus(logits) - yf * logits)
        resid = torch.sigmoid(logits) - yf
    elif family == "normal":
        s = torch.as_tensor(scale, dtype=compute_dtype, device=x.device)
        zscore = (logits - yf) / s
        nll = torch.sum(0.5 * zscore * zscore + torch.log(s) + _HALF_LOG_2PI)
        resid = (logits - yf) / (s * s)
    else:
        raise ValueError(f"unknown GLM family: {family!r}")
    grad = resid @ xf
    return nll.to(w.dtype), grad.to(w.dtype)


def _lib():
    lib = _build.load("glm_potential")
    fn = lib.glm_potential_grad_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.glm_potential_num_blocks.argtypes = [ctypes.c_longlong]
        lib.glm_potential_num_blocks.restype = ctypes.c_int
    return lib


def glm_potential_grad_cuda(x, y, w, offset=None, scale=None,
                            family="bernoulli_logit"):
    """Launch the two CUDA kernels (per-block partials, then the fixed-order
    fold) on the current stream.

    ``x``, ``y`` and ``offset`` must be contiguous float32 on one card with
    ``d <= MAX_D``; ``w`` may be float32 or float64 (the kernel computes in
    float32 and the result comes back in ``w.dtype``).  ``scale`` is a
    Python number (the Normal noise scale, fixed at setup).  Raises on
    anything else, and on a failed build or launch.
    """
    if family not in _FAMILIES:
        raise ValueError(f"unknown GLM family: {family!r}")
    if x.device.type != "cuda":
        raise ValueError(f"glm_potential_grad_cuda needs CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    n, d = x.shape
    if n == 0 or not 0 < d <= MAX_D:
        raise ValueError(f"glm_potential_grad_cuda takes n >= 1 and "
                         f"1 <= d <= {MAX_D}, got x of shape {(n, d)}")
    checks = [("x", x, (n, d)), ("y", y, (n,))]
    if offset is not None:
        checks.append(("offset", offset, (n,)))
    for name, t, shape in checks:
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"glm_potential_grad_cuda: {name} is {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous="
                f"{t.is_contiguous()}); expected contiguous float32 {shape} "
                f"on {x.device}")
    if w.device != x.device or tuple(w.shape) != (d,) \
            or w.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"glm_potential_grad_cuda: w is {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}; expected float "
                         f"({d},) on {x.device}")
    if family == "normal":
        if scale is None or isinstance(scale, torch.Tensor):
            raise TypeError("glm_potential_grad_cuda takes the Normal scale "
                            "as a Python number")
        scale = float(scale)
    else:
        scale = 1.0
    wf = w.to(torch.float32).contiguous()
    lib = _lib()
    blocks = lib.glm_potential_num_blocks(n)
    part_nll = torch.empty(blocks, dtype=torch.float32, device=x.device)
    part_grad = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    nll = torch.empty((), dtype=torch.float32, device=x.device)
    grad = torch.empty(d, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.glm_potential_grad_f32(
            x.data_ptr(), y.data_ptr(),
            None if offset is None else offset.data_ptr(), wf.data_ptr(),
            scale, _FAMILIES[family], n, d, part_nll.data_ptr(),
            part_grad.data_ptr(), blocks, nll.data_ptr(), grad.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"glm_potential_grad kernel launch failed: "
                           f"cudaError {rc}")
    glm_potential_grad_cuda.launches += 1
    return nll.to(w.dtype), grad.to(w.dtype)


glm_potential_grad_cuda.launches = 0
