"""Attention layers (the port of ``repro/models/attention.py``): GQA, which
covers MHA (kv == heads) and MQA (kv == 1).

- ``gqa_params(cfg, prefix, stacked)`` declares the weights through
  ``param`` sites (with the leading layer-stack dim);
- ``gqa_apply(cfg, w, x, rope)`` is the full-sequence forward (prefill),
  through ``ops.attention`` (the flash-attention kernel on a card);
- ``gqa_decode(cfg, w, x, cache, pos, rope)`` is one token against the KV
  cache, written in place at ``pos`` (the JAX package's
  ``dynamic_update_slice`` under buffer donation).

MLA and the int8 KV cache raise ``RPL501``.
"""
from __future__ import annotations

import torch

from ..core.errors import pending
from ..core.primitives import param
from ..kernels import ops
from .common import apply_rope, normal_init, ones_init, zeros_init
from .config import ModelConfig


def _p(name, shape, sharding, dtype, init=None):
    return param(name, shape=shape, init_fn=init or normal_init(0.02),
                 dtype=dtype, sharding=sharding)


def _stk(stacked, shape, sharding):
    """Prepend the layer-stack dim to shape/sharding when stacked > 0."""
    if stacked:
        return (stacked,) + shape, ("layers",) + sharding
    return shape, sharding


def _no_mla(cfg):
    if cfg.attn_type == "mla":
        raise pending("multi-head latent attention (attn_type='mla')",
                      "MoE/MLA")


def _no_int8(cfg):
    if cfg.kv_cache_int8:
        raise pending("the int8 KV cache (kv_cache_int8)",
                      "serving-optimisation")


# ---------------------------------------------------------------------------
# GQA (covers MHA: kv == heads; MQA: kv == 1)
# ---------------------------------------------------------------------------

def gqa_params(cfg: ModelConfig, prefix: str, stacked: int = 0):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    w = {}
    shape, shard = _stk(stacked, (d, H * hd), ("embed", "heads"))
    w["wq"] = _p(f"{prefix}.wq", shape, shard, dt)
    shape, shard = _stk(stacked, (d, K * hd), ("embed", "kv"))
    w["wk"] = _p(f"{prefix}.wk", shape, shard, dt)
    w["wv"] = _p(f"{prefix}.wv", shape, shard, dt)
    shape, shard = _stk(stacked, (H * hd, d), ("heads", "embed"))
    w["wo"] = _p(f"{prefix}.wo", shape, shard, dt)
    if cfg.qkv_bias:
        for n, dim in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            shape, shard = _stk(stacked, (dim,), ("heads",))
            w[n] = _p(f"{prefix}.{n}", shape, shard, dt, init=zeros_init())
    if cfg.qk_norm:
        shape, shard = _stk(stacked, (hd,), (None,))
        w["q_norm"] = _p(f"{prefix}.q_norm", shape, shard, torch.float32,
                         init=ones_init())
        w["k_norm"] = _p(f"{prefix}.k_norm", shape, shard, torch.float32,
                         init=ones_init())
    return w


def _qkv(cfg: ModelConfig, w, x):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.matmul(x, w["wq"].to(x.dtype))
    k = torch.matmul(x, w["wk"].to(x.dtype))
    v = torch.matmul(x, w["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + w["bq"].to(q.dtype)
        k = k + w["bk"].to(k.dtype)
        v = v + w["bv"].to(v.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, w["q_norm"])
        k = ops.rmsnorm(k, w["k_norm"])
    return q, k, v


def gqa_apply(cfg: ModelConfig, w, x, rope):
    """Full-sequence causal attention.  x: (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, w, x)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v)                       # (B, S, H, hd)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return torch.matmul(out, w["wo"].to(out.dtype))


def gqa_init_cache(cfg: ModelConfig, batch, seq_len, dtype, device,
                   stacked: int = 0):
    """Zeroed k/v caches (B, S, K, hd), with the leading layer-stack dim
    when ``stacked`` > 0: one allocation per tensor for all layers."""
    _no_int8(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = ((stacked,) if stacked else ()) + (batch, seq_len, K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(cfg: ModelConfig, w, x, cache, pos, rope):
    """x: (B, 1, d); cache k/v: (B, S, K, hd); pos: the write index (a
    host int).  ``rope`` is the (cos, sin) pair evaluated AT pos
    (common.rope_at).  Writes this token's k/v into the cache in place and
    returns ``(y, cache)``."""
    _no_int8(cfg)
    B = x.shape[0]
    q, k, v = _qkv(cfg, w, x)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k[:, 0].to(ck.dtype)
    cv[:, pos] = v[:, 0].to(cv.dtype)
    S = ck.shape[1]
    mask = (torch.arange(S, device=x.device) <= pos)[None, :]   # (1, S)
    out = ops.decode_attention(q, ck, cv, mask)                 # (B, 1, H, hd)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    y = torch.matmul(out, w["wo"].to(out.dtype))
    return y, cache


# ---------------------------------------------------------------------------
# dispatch table
# ---------------------------------------------------------------------------

def attn_params(cfg: ModelConfig, prefix: str, stacked: int = 0):
    _no_mla(cfg)
    return gqa_params(cfg, prefix, stacked)


def attn_apply(cfg: ModelConfig, w, x, rope):
    _no_mla(cfg)
    return gqa_apply(cfg, w, x, rope)


def attn_init_cache(cfg: ModelConfig, batch, seq_len, dtype, device,
                    stacked: int = 0):
    _no_mla(cfg)
    return gqa_init_cache(cfg, batch, seq_len, dtype, device, stacked)


def attn_decode(cfg: ModelConfig, w, x, cache, pos, rope):
    _no_mla(cfg)
    return gqa_decode(cfg, w, x, cache, pos, rope)
