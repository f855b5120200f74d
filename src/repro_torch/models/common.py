"""Shared model building blocks (the port of ``repro/models/common.py``).

Weights are declared through the paper's ``param`` effect primitive, so the
same model code runs under ``seed`` for initialization and with an explicit
params tree for apply.  The initializers draw on the device of the
generator ``seed`` hands them, so a model initialized from a CUDA generator
is drawn on the card, never on the host.

Weights carry logical sharding names (``sharding=`` of their ``param``
site).  Under :func:`sharding_ctx` a model's activations are laid out by
:func:`constrain` at the JAX package's sites: the names map through the
rules (``distributed.sharding.make_rules``) to DTensor placements on the
mesh, and the tensor is redistributed to them.  Off a mesh ``constrain``
returns its input.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.primitives import param

# ---------------------------------------------------------------------------
# logical sharding context
# ---------------------------------------------------------------------------

_SHARDING_CTX = {"mesh": None, "rules": None}


@contextmanager
def sharding_ctx(mesh, rules):
    """Lay a model's activations out on ``mesh`` by ``rules`` inside."""
    old = dict(_SHARDING_CTX)
    _SHARDING_CTX.update(mesh=mesh, rules=rules)
    try:
        yield
    finally:
        _SHARDING_CTX.update(old)


def current_mesh():
    return _SHARDING_CTX["mesh"]


def current_rules():
    return _SHARDING_CTX["rules"]


def logical_to_spec(names: Optional[Sequence[Optional[str]]]):
    """Logical axis names -> a spec tuple under the active rules, or None.
    A name ABSENT from the rules disables the whole constraint (the layout
    is left as it is), where a name mapped to None replicates its dim."""
    from ..distributed.sharding import logical_to_partition
    rules = _SHARDING_CTX["rules"]
    if names is None or rules is None:
        return None
    if any(n is not None and n not in rules for n in names):
        return None
    return logical_to_partition(names, rules)


def constrain_spec(x, spec):
    """``x`` laid out by an explicit spec tuple on the active mesh; the
    input itself off a mesh."""
    mesh = _SHARDING_CTX["mesh"]
    if mesh is None or spec is None:
        return x
    from ..distributed.sharding import place, spec_to_placements
    return place(x, mesh, spec_to_placements(spec, mesh))


def constrain(x, names: Optional[Sequence[Optional[str]]]):
    """``x`` laid out by logical names on the active mesh (the JAX
    package's ``with_sharding_constraint``); the input itself off a mesh or
    when a name is absent from the rules."""
    if _SHARDING_CTX["mesh"] is None:
        return x
    return constrain_spec(x, logical_to_spec(names))

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
