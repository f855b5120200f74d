"""Shared model building blocks (the port of ``repro/models/common.py``).

Weights are declared through the paper's ``param`` effect primitive, so the
same model code runs under ``seed`` for initialization and with an explicit
params tree for apply.  The initializers draw on the device of the
generator ``seed`` hands them, so a model initialized from a CUDA generator
is drawn on the card, never on the host.

The JAX package's logical-sharding context (``sharding_ctx``,
``constrain``) has no effect on one card and is not ported: it waits for
the multi-GPU item of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.primitives import param

# ---------------------------------------------------------------------------
# initializers: (generator, shape, dtype) -> tensor on the generator's device
# ---------------------------------------------------------------------------

def normal_init(stddev):
    def init(gen, shape, dtype):
        draw = torch.randn(shape, generator=gen, device=gen.device)
        return (draw * stddev).to(dtype)
    return init


def zeros_init():
    def init(gen, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=gen.device)
    return init


def ones_init():
    def init(gen, shape, dtype):
        return torch.ones(shape, dtype=dtype, device=gen.device)
    return init


# ---------------------------------------------------------------------------
# parameter sites
# ---------------------------------------------------------------------------

def embedding(name, vocab_size, dim, *, dtype=torch.bfloat16):
    return param(f"{name}.embedding", shape=(vocab_size, dim),
                 init_fn=normal_init(0.02), dtype=dtype,
                 sharding=("vocab", "embed"))


def rmsnorm_weight(name, dim, *, stacked: int = 0, dtype=torch.float32):
    shape = ((stacked,) if stacked else ()) + (dim,)
    sharding = ((None,) if stacked else ()) + (None,)
    return param(f"{name}.scale", shape=shape, init_fn=ones_init(),
                 dtype=dtype, sharding=sharding)


# ---------------------------------------------------------------------------
# rotary position embeddings (halves split, not interleaved; float32 math)
# ---------------------------------------------------------------------------

def _inv_freq(head_dim, base, device):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (base ** exponents)


def rope_frequencies(head_dim, max_seq, base=10000.0, dtype=torch.float32,
                     device=None):
    """cos/sin tables, each (max_seq, head_dim / 2)."""
    inv = _inv_freq(head_dim, base, device)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def rope_at(pos, head_dim, base=10000.0, dtype=torch.float32, device=None):
    """cos/sin rows for one position, each (1, head_dim / 2): O(head_dim),
    no table."""
    freqs = float(pos) * _inv_freq(head_dim, base, device)
    return (torch.cos(freqs)[None].to(dtype),
            torch.sin(freqs)[None].to(dtype))


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd) at positions 0..S-1 of cos/sin (S_max, hd/2)."""
    S = x.shape[-3]
    cos = cos[:S][None, :, None, :]
    sin = sin[:S][None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def swiglu(gate, up):
    return F.silu(gate.float()).to(gate.dtype) * up


def geglu(gate, up):
    return F.gelu(gate.float(), approximate="tanh").to(gate.dtype) * up
