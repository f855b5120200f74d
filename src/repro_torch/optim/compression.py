"""Gradient compression for the cross-pod data-parallel reduction (the port
of ``repro/optim/compression.py``).

Int8 block quantization with error feedback: the quantization residual is
carried in a local buffer and added back the next step, so the compression
error does not accumulate (Karimireddy et al., 2019).  On a multi-pod mesh
it runs just before the cross-pod reduction, which then moves ~4x fewer
bytes (an int8 payload and a float32 scale per block of 256).  The
arithmetic is the JAX package's, in float32 and in the same order, so both
packages compress the same gradients to the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .optimizers import tree_map

BLOCK = 256


def _pad_to_block(x):
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n


def int8_compress(x):
    """``x`` -> ``(int8 payload (blocks, 256), float32 scale a block,
    original size)``."""
    flat, n = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scales = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scales = torch.clamp(scales, min=1e-12)
    q = torch.clamp(torch.round(blocks / scales), -127, 127).to(torch.int8)
    return q, scales[:, 0], n


def int8_decompress(q, scales, n, shape, dtype=torch.float32):
    blocks = q.float() * scales[:, None]
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def int8_compress_decompress(x):
    """The round trip: what the receiving pod reconstructs."""
    q, s, n = int8_compress(x)
    return int8_decompress(q, s, n, x.shape, x.dtype)


class EFState(NamedTuple):
    residual: dict


def error_feedback_init(grads):
    return EFState(tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def error_feedback_compress(grads, ef_state: EFState):
    """Add the carried residual, compress, carry the new residual.

    Returns ``(compressed grads, new EFState)``.  The compressed gradients
    are already dequantized, so any sum or mean over ranks applies to them
    unchanged."""
    def one(g, r):
        corrected = g.float() + r
        sent = int8_compress_decompress(corrected)
        return _Sent(sent.to(g.dtype), corrected - sent)

    outs = tree_map(one, grads, ef_state.residual)
    return _pick(outs, 0), EFState(_pick(outs, 1))


class _Sent(NamedTuple):
    grad: torch.Tensor
    residual: torch.Tensor


def _pick(tree, i):
    """Field ``i`` of the :class:`_Sent` pairs at the leaves of ``tree``."""
    if isinstance(tree, _Sent):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    items = [_pick(v, i) for v in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)
