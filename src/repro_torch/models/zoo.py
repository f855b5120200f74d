"""Model zoo (the port of ``repro/models/zoo.py``): build init, forward and
decode for the dense GQA families (qwen3-8b, llama3-405b, qwen1.5-32b,
gemma-2b) and the Mamba-2 SSM family (mamba2-370m).  The other families
raise ``RPL501``, naming the slice they wait for.

As in the JAX package, weights are declared through the ``param`` effect
primitive, so the same model function runs under ``seed`` (initialization)
and with an explicit params tree (apply).  Per-layer weights carry a leading
stack dim, so a JAX params tree carries over leaf by leaf
(``interop.lm_params_from_reference``); where the JAX package runs
``lax.scan`` over that dim, the port loops over views of it.  The KV cache
is one preallocated (L, B, S, K, hd) tensor per k and v, written in place
one position per decode step; an SSM layer's cache is one (L, B, h, p, n)
float32 state and one (L, B, width - 1, conv_ch) conv tail, written in place
each step.

Under ``common.sharding_ctx`` the dense families train on a device mesh:
the parameters are DTensors placed by their logical names
(``distributed.sharding.param_shardings`` of :meth:`LM.abstract_params`),
the activations are laid out at the JAX package's ``constrain`` sites, and
the kernels of ``ops`` run on each rank's local shards.  The SSM family and
decoding under a mesh raise ``RPL501``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..core import handlers
from ..core.errors import pending
from ..core.infer.hmc import resolve_device
from ..core.primitives import param
from ..distributed.sharding import (grad_placements, place, replicate,
                                    whole_seq)
from ..kernels import ops
from . import attention as attn
from . import mlp as mlpm
from . import ssm as ssmm
from .common import (constrain, current_mesh, embedding, normal_init,
                     rmsnorm_weight, rope_at, rope_frequencies)
from .config import ModelConfig

# ---------------------------------------------------------------------------
# layer schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str                   # attn | attn_bidir | ssm | none
    ffn: Optional[str]           # mlp | moe | None
    d_ff: int = 0
    cross: bool = False          # decoder cross-attention


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    n: int                       # stack length (layers or periods)
    specs: Tuple[LayerSpec, ...]  # unrolled pattern inside one stack entry


def layer_groups(cfg: ModelConfig) -> List[Group]:
    if cfg.is_encoder_decoder:
        return [
            Group("encoder", cfg.num_encoder_layers,
                  (LayerSpec("attn_bidir", "mlp", cfg.d_ff),)),
            Group("decoder", cfg.num_layers,
                  (LayerSpec("attn", "mlp", cfg.d_ff, cross=True),)),
        ]
    if cfg.family == "ssm":
        return [Group("layers", cfg.num_layers, (LayerSpec("ssm", None),))]
    if cfg.family == "hybrid":
        period = cfg.attn_layer_period
        specs = tuple(
            LayerSpec("attn" if cfg.is_attn_layer(i) else "ssm",
                      "moe" if cfg.is_moe_layer(i) else "mlp",
                      cfg.moe_d_ff if cfg.is_moe_layer(i) else cfg.d_ff)
            for i in range(period))
        return [Group("periods", cfg.num_layers // period, specs)]
    if cfg.moe:
        gs = []
        if cfg.first_k_dense:
            gs.append(Group("dense", cfg.first_k_dense,
                            (LayerSpec("attn", "mlp", cfg.d_ff),)))
        gs.append(Group("moe", cfg.num_layers - cfg.first_k_dense,
                        (LayerSpec("attn", "moe", cfg.moe_d_ff),)))
        return gs
    return [Group("layers", cfg.num_layers, (LayerSpec("attn", "mlp",
                                                       cfg.d_ff),))]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``RPL501`` for a configuration this port cannot build yet."""
    if cfg.is_encoder_decoder:
        raise pending(f"{cfg.name}: encoder-decoder models", "MoE/MLA/enc-dec")
    if cfg.family == "hybrid":
        raise pending(f"{cfg.name}: the hybrid family's MoE layers beside "
                      "its SSM and attention layers", "MoE/MLA/enc-dec")
    if cfg.moe or cfg.attn_type == "mla":
        raise pending(f"{cfg.name}: MoE / MLA layers", "MoE/MLA/enc-dec")
    if cfg.frontend or cfg.mtp or cfg.family not in ("dense", "ssm"):
        raise pending(f"{cfg.name}: the {cfg.family} family's extras "
                      "(multimodal frontend, multi-token prediction)",
                      "MoE/MLA/enc-dec")


# ---------------------------------------------------------------------------
# per-block params / apply / decode / cache
# ---------------------------------------------------------------------------

def _block_params(cfg: ModelConfig, prefix: str, spec: LayerSpec, stacked):
    """A block's weights: ``ln1`` and the mixer (attention or SSM), then
    ``ln2`` and the gated MLP where the block has an FFN (mamba2's have
    none)."""
    w = {"ln1": rmsnorm_weight(f"{prefix}.ln1", cfg.d_model, stacked=stacked)}
    if spec.mixer == "ssm":
        w["mixer"] = ssmm.ssm_params(cfg, f"{prefix}.ssm", stacked)
    else:
        w["mixer"] = attn.attn_params(cfg, f"{prefix}.attn", stacked)
    if spec.ffn is not None:
        w["ln2"] = rmsnorm_weight(f"{prefix}.ln2", cfg.d_model,
                                  stacked=stacked)
        w["ffn"] = mlpm.mlp_params(cfg, f"{prefix}.mlp", stacked,
                                   d_ff=spec.d_ff)
    return w


def _block_apply(cfg: ModelConfig, spec: LayerSpec, w, x, rope):
    """Full-sequence block: x (B, S, d) -> x.  On a mesh, block-internal
    activations take the ``seq_inner`` rule (the sequence gathered when
    ``sp_scoped``) and each branch joins the residual stream in its
    ``seq`` layout."""
    h = ops.rmsnorm(x, w["ln1"])
    h = constrain(h, ("batch", "seq_inner", None))
    if spec.mixer == "ssm":
        h = ssmm.ssm_apply(cfg, w["mixer"], h)
    else:
        h = attn.attn_apply(cfg, w["mixer"], h, rope)
    x = x + constrain(h, ("batch", "seq", None))
    if spec.ffn is not None:
        h = ops.rmsnorm(x, w["ln2"])
        h = constrain(h, ("batch", "seq_inner", None))
        h = mlpm.mlp_apply(cfg, w["ffn"], h)
        x = x + constrain(h, ("batch", "seq", None))
    return x


def _block_decode(cfg: ModelConfig, spec: LayerSpec, w, x, cache, pos, rope):
    """Single-token decode: x (B, 1, d) -> (x, cache), the cache written in
    place."""
    h = ops.rmsnorm(x, w["ln1"])
    if spec.mixer == "ssm":
        h, _ = ssmm.ssm_decode(cfg, w["mixer"], h, cache["ssm"])
    else:
        h, _ = attn.attn_decode(cfg, w["mixer"], h, cache["kv"], pos, rope)
    x = x + h
    if spec.ffn is not None:
        x = x + mlpm.mlp_apply(cfg, w["ffn"], ops.rmsnorm(x, w["ln2"]))
    return x, cache


def _block_cache(cfg: ModelConfig, spec: LayerSpec, batch, seq_len, dtype,
                 device, stacked: int = 0):
    if spec.mixer == "ssm":
        return {"ssm": ssmm.ssm_init_cache(cfg, batch, dtype, device,
                                           stacked)}
    return {"kv": attn.attn_init_cache(cfg, batch, seq_len, dtype, device,
                                       stacked)}


def _unbind(tree, n):
    """The ``n`` layers of every stacked leaf of ``tree``, one
    ``torch.unbind`` per leaf: a list of ``n`` trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return torch.unbind(tree, 0)


def _requires_grad(tree):
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "full")  # the JAX package's "dots" is not ported


class LM:
    """A decoder-only language model built from a :class:`ModelConfig`,
    expressed with ``param`` effect sites.  ``remat`` is ``"full"`` (each
    layer recomputed in the backward, the JAX package's default) or
    ``"none"``; ``"dots"`` raises ``RPL501``."""

    def __init__(self, cfg: ModelConfig, remat: str = "full"):
        check_supported(cfg)
        if remat == "dots":
            raise pending("the 'dots' rematerialization policy", "training")
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat is one of {REMAT_POLICIES}, got {remat!r}")
        self.cfg = cfg
        self.groups = layer_groups(cfg)
        self.remat = remat

    # -- parameters ---------------------------------------------------------
    def params_fn(self):
        cfg = self.cfg
        w = {"embed": embedding("embed", cfg.vocab_size, cfg.d_model,
                                dtype=cfg.torch_dtype)}
        for g in self.groups:
            w[g.name] = {
                f"p{j}": _block_params(cfg, f"{g.name}.p{j}", spec, g.n)
                for j, spec in enumerate(g.specs)
            }
        w["final_norm"] = rmsnorm_weight("final_norm", cfg.d_model)
        if not cfg.tie_embeddings:
            w["unembed"] = param("unembed", shape=(cfg.d_model,
                                                   cfg.vocab_size),
                                 init_fn=normal_init(0.02),
                                 dtype=cfg.torch_dtype,
                                 sharding=("embed", "vocab"))
        return w

    def init(self, rng, device="cuda"):
        """Draw every parameter from ``rng``: a ``torch.Generator``, whose
        device the draws are made on, or an int that seeds a new generator
        on ``device`` (default the card; ``RPL502`` without one)."""
        if not isinstance(rng, torch.Generator):
            rng = torch.Generator(device=resolve_device(device)).manual_seed(
                int(rng))
        return handlers.seed(self.params_fn, rng)()

    def abstract_params(self):
        """``(shapes, specs)``: the parameter tree as tensors on the
        ``meta`` device (shapes and dtypes, no memory) and the same tree of
        each ``param`` site's logical sharding names."""
        specs = {}

        class _record(_meta_params):
            def process_message(self, msg):
                super().process_message(msg)
                if msg["type"] == "param":
                    specs[id(msg["value"])] = msg["kwargs"].get("sharding")

        with _record():
            shapes = self.params_fn()

        def names(tree):
            if isinstance(tree, dict):
                return {k: names(v) for k, v in tree.items()}
            return specs.get(id(tree))
        return shapes, names(shapes)

    # -- embedding / head ----------------------------------------------------
    def _embed(self, w, tokens):
        if isinstance(tokens, DTensor):
            x = _mesh_embed(w["embed"], tokens)
        else:
            x = w["embed"][tokens]
        if self.cfg.tie_embeddings:  # gemma-style sqrt(d) scaling
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _unembed_w(self, w):
        return w["embed"].T if self.cfg.tie_embeddings else w["unembed"]

    def _rope(self, seq_len, device):
        """cos/sin tables; on a mesh replicated DTensors, which a
        sequence-sharded activation meets at its own positions."""
        cfg = self.cfg
        tables = rope_frequencies(cfg.head_dim, max(seq_len, 1),
                                  base=cfg.rope_base, device=device)
        mesh = current_mesh()
        if mesh is None:
            return tables
        return tuple(place(t, mesh, [Replicate()] * mesh.ndim)
                     for t in tables)

    # -- the layer stack ------------------------------------------------------
    def _run_groups(self, w, x, rope):
        cfg = self.cfg
        remat = self.remat == "full" and torch.is_grad_enabled()
        for g in self.groups:
            # recompute in the backward only where a backward can happen:
            # serving runs with grad enabled but nothing requiring it
            ckpt = remat and (x.requires_grad or _requires_grad(w[g.name]))

            def body(x, wi, _g=g):
                x = constrain(x, ("batch", "seq", None))
                for j, spec in enumerate(_g.specs):
                    x = _block_apply(cfg, spec, wi[f"p{j}"], x, rope)
                return constrain(x, ("batch", "seq", None))

            for wi in _unbind(w[g.name], g.n):
                x = checkpoint(body, x, wi, use_reentrant=False,
                               preserve_rng_state=False) if ckpt \
                    else body(x, wi)
        return x

    # -- training / prefill forward ------------------------------------------
    def forward(self, w, batch, return_logits=False):
        """batch: ``{"tokens": (B, S)}`` [+ ``"labels"`` (B, S)].  Returns
        ``(loss, metrics)``, the next-token logits (B, V) with
        ``return_logits="last"`` (prefill), or all of them (B, S, V) with
        ``True``.  The loss is ``mean(ce) + mean(z_loss)`` through
        ``ops.softmax_xent``; ``metrics`` holds ``ce``, ``z_loss`` and
        ``loss``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "ssm" and current_mesh() is not None:
            raise pending(f"{cfg.name}: the SSM family under a mesh",
                          "mamba2 training")
        B, S = tokens.shape
        x = self._embed(w, tokens)
        x = constrain(x, ("batch", "seq", None))
        rope = self._rope(S, x.device)
        x = self._run_groups(w, x, rope)
        x = ops.rmsnorm(x, w["final_norm"])
        uw = self._unembed_w(w)
        if return_logits == "last":   # prefill: logits for the next token
            return torch.matmul(x[:, -1:], uw.to(x.dtype))[:, 0]
        if return_logits:
            return torch.matmul(x, uw.to(x.dtype))
        ce, zl = ops.softmax_xent(whole_seq(x).reshape(B * S, cfg.d_model),
                                  uw.to(x.dtype), batch["labels"].reshape(-1),
                                  z_loss_weight=cfg.z_loss_weight)
        ce, zl = replicate(ce.mean()), replicate(zl.mean())
        loss = ce + zl
        return loss, {"ce": ce, "z_loss": zl, "loss": loss}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch, seq_len, device="cuda"):
        """Zeroed decode caches on ``device`` (default the card; ``RPL502``
        without one), stacked over each group's layers: a (n, B, S, K, hd) k
        and v for attention layers, a (n, B, h, p, n) float32 state and a
        (n, B, width - 1, conv_ch) conv tail for SSM layers (``seq_len`` is
        then unused)."""
        _no_mesh_decoding()
        device = resolve_device(device)
        cfg = self.cfg
        return {g.name: {f"p{j}": _block_cache(cfg, spec, batch, seq_len,
                                               cfg.torch_dtype, device, g.n)
                         for j, spec in enumerate(g.specs)}
                for g in self.groups}

    def decode_step(self, w, tokens, cache, pos):
        """tokens: (B, 1) -> (logits (B, V), cache).  ``pos`` is the host
        int position written; the cache is updated in place and returned.
        RoPE is evaluated at ``pos`` directly, with no (S, hd) table."""
        _no_mesh_decoding()
        cfg = self.cfg
        pos = int(pos)
        x = self._embed(w, tokens)
        rope = rope_at(pos, cfg.head_dim, base=cfg.rope_base, device=x.device)
        for g in self.groups:
            for wi, ci in zip(_unbind(w[g.name], g.n),
                              _unbind(cache[g.name], g.n)):
                for j, spec in enumerate(g.specs):
                    x, _ = _block_decode(cfg, spec, wi[f"p{j}"], x,
                                         ci[f"p{j}"], pos, rope)
        x = ops.rmsnorm(x, w["final_norm"])
        logits = torch.matmul(x, self._unembed_w(w).to(x.dtype))[:, 0]
        return logits, cache


def _no_mesh_decoding():
    if current_mesh() is not None:
        raise pending("decoding under a mesh (serving takes one device)",
                      "multi-GPU serving")


def _mesh_embed(table, tokens):
    """The embedding lookup of DTensor ``tokens`` on every rank's own
    tokens against the whole table (gathered once), in the tokens'
    layout; the table's gradient sums over the ranks that split the
    tokens."""
    mesh = tokens.device_mesh
    rep = (Replicate(),) * mesh.ndim
    grad = grad_placements(mesh, tokens.placements)
    return local_map(lambda t, idx: t[idx],
                     out_placements=list(tokens.placements),
                     in_placements=(rep, tokens.placements),
                     in_grad_placements=(grad, tokens.placements),
                     device_mesh=mesh, redistribute_inputs=True)(table,
                                                                 tokens)


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------

class _meta_params(handlers.Messenger):
    """Materialize every param site as an empty tensor on the ``meta``
    device: shapes and dtypes, no memory."""

    def process_message(self, msg):
        if msg["type"] == "param" and msg["value"] is None:
            kw = msg["kwargs"]
            msg["value"] = torch.empty(kw["shape"], dtype=kw["dtype"],
                                       device="meta")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of a configuration this port builds (no memory is
    allocated)."""
    with _meta_params():
        w = LM(cfg).params_fn()
    return sum(leaf.numel() for leaf in _leaves(w))
