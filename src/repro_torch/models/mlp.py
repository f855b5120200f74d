"""The dense gated MLP (SwiGLU / GeGLU), the port of
``repro/models/mlp.py``'s dense half.  Mixture-of-experts waits for its
slice: an MoE config raises ``RPL501`` when its ``LM`` is built
(``zoo.check_supported``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.primitives import param
from ..distributed.sharding import whole_seq
from . import common
from .common import normal_init
from .config import ModelConfig


def _p(name, shape, sharding, dtype, init=None):
    return param(name, shape=shape, init_fn=init or normal_init(0.02),
                 dtype=dtype, sharding=sharding)


def _stk(stacked, shape, sharding):
    if stacked:
        return (stacked,) + shape, ("layers",) + sharding
    return shape, sharding


def mlp_params(cfg: ModelConfig, prefix: str, stacked: int = 0,
               d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.torch_dtype
    w = {}
    shape, shard = _stk(stacked, (d, f), ("embed", "mlp"))
    w["wg"] = _p(f"{prefix}.wg", shape, shard, dt)
    w["wu"] = _p(f"{prefix}.wu", shape, shard, dt)
    shape, shard = _stk(stacked, (f, d), ("mlp", "embed"))
    w["wd"] = _p(f"{prefix}.wd", shape, shard, dt)
    return w


def mlp_apply(cfg: ModelConfig, w, x):
    act = common.geglu if cfg.mlp_act == "geglu" else common.swiglu
    x = whole_seq(x)
    g = torch.matmul(x, w["wg"].to(x.dtype))
    u = torch.matmul(x, w["wu"].to(x.dtype))
    return torch.matmul(act(g, u), w["wd"].to(x.dtype))
