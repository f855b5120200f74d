"""The Mamba-2 (SSD, state-space duality) mixer layer (the port of
``repro/models/ssm.py``).

Prefill runs the chunked SSD scan through ``ops.ssd_scan`` (the
``csrc/ssd_scan.cu`` kernel on a card); decode is an O(1)-per-token state
update through ``ops.ssd_decode_step``.  Used standalone (mamba2-370m); the
Jamba hybrid, which also needs MoE, is not built yet.

Each step mirrors the reference's types: the prefill's depthwise causal conv
is a sum of shifted products in x's dtype (rounded after every product and
sum), decode's is a float32 contraction over the cache; ``dt`` is
``softplus`` as ``logaddexp(x, 0)`` (``jax.nn.softplus``).  The decode cache
(state and conv tail) is written in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.primitives import param
from ..kernels import ops
from .common import normal_init, ones_init, zeros_init
from .config import ModelConfig

N_GROUPS = 1  # B/C projection groups (mamba2-370m and jamba use 1)


def _p(name, shape, sharding, dtype, init=None):
    return param(name, shape=shape, init_fn=init or normal_init(0.02),
                 dtype=dtype, sharding=sharding)


def _stk(stacked, shape, sharding):
    if stacked:
        return (stacked,) + shape, ("layers",) + sharding
    return shape, sharding


def _uniform_init(low, high, transform):
    """``transform(uniform(low, high))`` drawn on the generator's device."""
    def init(gen, shape, dtype):
        u = torch.rand(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)
        return transform(low + (high - low) * u).to(dtype)
    return init


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_ch = d_in + 2 * N_GROUPS * n
    return d_in, h, n, conv_ch


def ssm_params(cfg: ModelConfig, prefix: str, stacked: int = 0):
    d = cfg.d_model
    d_in, h, n, conv_ch = ssm_dims(cfg)
    dt = cfg.torch_dtype
    w = {}
    proj_out = 2 * d_in + 2 * N_GROUPS * n + h
    shape, shard = _stk(stacked, (d, proj_out), ("embed", "mlp"))
    w["w_in"] = _p(f"{prefix}.w_in", shape, shard, dt)
    shape, shard = _stk(stacked, (cfg.ssm_conv_width, conv_ch), (None, "mlp"))
    w["conv_w"] = _p(f"{prefix}.conv_w", shape, shard, dt,
                     init=normal_init(0.1))
    shape, shard = _stk(stacked, (conv_ch,), ("mlp",))
    w["conv_b"] = _p(f"{prefix}.conv_b", shape, shard, dt, init=zeros_init())
    shape, shard = _stk(stacked, (h,), ("mlp",))
    w["A_log"] = _p(f"{prefix}.A_log", shape, shard, torch.float32,
                    init=_uniform_init(1.0, 16.0, torch.log))
    w["D"] = _p(f"{prefix}.D", shape, shard, torch.float32, init=ones_init())
    w["dt_bias"] = _p(f"{prefix}.dt_bias", shape, shard, torch.float32,
                      init=_uniform_init(
                          1e-3, 0.1, lambda u: torch.log(torch.expm1(u))))
    shape, shard = _stk(stacked, (d_in,), ("mlp",))
    w["norm"] = _p(f"{prefix}.norm", shape, shard, torch.float32,
                   init=ones_init())
    shape, shard = _stk(stacked, (d_in, d), ("mlp", "embed"))
    w["w_out"] = _p(f"{prefix}.w_out", shape, shard, dt)
    return w


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, h, n, _ = ssm_dims(cfg)
    g = N_GROUPS
    return torch.split(zxbcdt, [d_in, d_in, g * n, g * n, h], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no linear branch."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gated_norm(y, z, scale, eps=1e-6):
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    out = yf * torch.rsqrt(var + eps) * scale.float()
    return out.to(y.dtype)


def ssm_apply(cfg: ModelConfig, w, x, h0=None, conv0=None,
              return_state=False):
    """Full-sequence SSD mixer. x: (B, S, d) -> (B, S, d).

    With ``return_state`` also returns (ssm_state, conv_state) for chunked
    prefill / handoff to decode.
    """
    Bz, S, d = x.shape
    d_in, h, n, conv_ch = ssm_dims(cfg)
    g = N_GROUPS
    p = cfg.ssm_head_dim
    width = cfg.ssm_conv_width
    zxbcdt = torch.matmul(x, w["w_in"].to(x.dtype))
    z, xs, Bm, Cm, dtr = _split_proj(cfg, zxbcdt)

    xbc = torch.cat([xs, Bm, Cm], dim=-1)               # (B, S, conv_ch)
    if conv0 is None:
        pad = torch.zeros((Bz, width - 1, conv_ch), dtype=xbc.dtype,
                          device=x.device)
    else:
        pad = conv0.to(xbc.dtype)
    xbc_pad = torch.cat([pad, xbc], dim=1)
    # depthwise causal conv as a sum of shifted scaled copies (width is 4)
    conv_w = w["conv_w"].to(xbc.dtype)
    conv = sum(xbc_pad[:, i:i + S] * conv_w[i] for i in range(width))
    conv = conv + w["conv_b"].to(conv.dtype)
    conv = F.silu(conv.float()).to(x.dtype)
    xs, Bm, Cm = torch.split(conv, [d_in, g * n, g * n], dim=-1)

    dt = _softplus(dtr.float() + w["dt_bias"].float())
    A = -torch.exp(w["A_log"].float())
    y, state = ops.ssd_scan(
        xs.reshape(Bz, S, h, p), dt, A,
        Bm.reshape(Bz, S, g, n), Cm.reshape(Bz, S, g, n),
        chunk=min(cfg.ssm_chunk, S), D=w["D"], h0=h0)
    y = _gated_norm(y.reshape(Bz, S, d_in), z, w["norm"])
    out = torch.matmul(y, w["w_out"].to(y.dtype))
    if return_state:
        conv_tail = xbc_pad[:, S:S + width - 1]
        if conv_tail.shape[1] < width - 1:  # S < width - 1
            conv_tail = xbc_pad[:, -(width - 1):]
        return out, (state, conv_tail)
    return out


def ssm_init_cache(cfg: ModelConfig, batch, dtype, device, stacked: int = 0):
    """The zeroed decode cache: the float32 state (B, h, p, n) and the conv
    tail (B, width - 1, conv_ch) in ``dtype``, with the leading layer-stack
    dim when ``stacked`` > 0 (one allocation per leaf for all layers)."""
    d_in, h, n, conv_ch = ssm_dims(cfg)
    lead = (stacked,) if stacked else ()
    return {
        "state": torch.zeros(lead + (batch, h, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def ssm_decode(cfg: ModelConfig, w, x, cache):
    """One-token decode. x: (B, 1, d).  Returns ``(y, cache)``, the cache's
    state and conv tail written in place."""
    Bz = x.shape[0]
    d_in, h, n, conv_ch = ssm_dims(cfg)
    g = N_GROUPS
    p = cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, w["w_in"].to(x.dtype))
    z, xs, Bm, Cm, dtr = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]         # (B, conv_ch)

    # a fresh buffer: shifting the cache onto itself would overlap
    conv_buf = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B, w, ch)
    conv = torch.einsum("bwc,wc->bc", conv_buf.float(), w["conv_w"].float())
    conv = conv + w["conv_b"].float()
    conv = F.silu(conv).to(x.dtype)
    xs, Bm, Cm = torch.split(conv, [d_in, g * n, g * n], dim=-1)

    dt = _softplus(dtr.float()[:, 0] + w["dt_bias"].float())
    A = -torch.exp(w["A_log"].float())
    y, state = ops.ssd_decode_step(
        cache["state"], xs.reshape(Bz, h, p), dt, A,
        Bm.reshape(Bz, g, n), Cm.reshape(Bz, g, n), D=w["D"])
    y = _gated_norm(y.reshape(Bz, 1, d_in), z, w["norm"])
    out = torch.matmul(y, w["w_out"].to(y.dtype))
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_buf[:, 1:])
    return out, cache
