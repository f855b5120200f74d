"""Mesh placements and collectives (the port of the JAX package's
``repro/distributed/sharding.py``): the inference mesh's half, then the LM
half.

The MCMC executor's mesh (``launch.mesh.make_inference_mesh``) is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over ranks, one device each, with the dims ``("chains",)`` or ``("chains",
"data")``.  Three placements say where what lies (as DTensor placements, one
per mesh dim):

- per-chain state (:func:`chain_placements`): rows over ``chains``,
  replicated over ``data``;
- shared state (:func:`replicated_placements`): on every rank;
- the likelihood's data rows (:func:`data_placements`): rows over ``data``,
  replicated over ``chains``.

:func:`local_block` and :func:`local_rows` give a rank's rows by them (the
even split of ``Shard(0)``), :func:`all_gather_rows` and :func:`gather_tree`
put the rows of a mesh dim back together in rank order, which is row
order.

Kernels stay mesh-agnostic, as in the JAX package: a ``KernelSetup`` only
says that its potential is data-shardable (``data_axis``), and the
executor activates its mesh with :func:`use_inference_mesh` around the run;
the potential reads it through :func:`active_data_mesh`, a cross-chain
kernel's batched potential through :func:`active_ensemble_split`, and the
pooled mass adaptation of a lockstep batch split over chain ranks through
:func:`active_chain_rows`.

The LM half maps logical axis names (``"batch"``, ``"embed"``, ``"heads"``,
...) to mesh dims by :func:`make_rules`, as the JAX package does, and a
partition spec to DTensor placements by :func:`spec_to_placements`.  A spec
is a tuple with the entries of the JAX package's ``PartitionSpec`` (a mesh
dim's name, a tuple of names, or None per tensor dim), so ``tuple(P)`` of
the reference compares with it directly.  A mesh is a ``DeviceMesh`` or,
for the pure-logic functions, a :class:`MeshShape` (named dims, no
devices).

A collective over a mesh dim of one rank moves nothing: the gathers and
the barrier return at once there, and :func:`spec_to_placements` gives such
a dim ``Replicate()``, so no redistribute or reduction runs over it.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

DP_AXES_1POD = ("data",)
DP_AXES_MPOD = ("pod", "data")

# the inference mesh's dims: chains on one, the likelihood's data rows on
# the other (launch.mesh.make_inference_mesh)
CHAIN_AXIS = "chains"
DATA_AXIS = "data"

_INFERENCE_CTX = {"mesh": None, "data_axis": None, "ensemble": False}
# one collective into one output tensor (all_gather_into_tensor before
# torch 2.13)
_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@contextmanager
def use_inference_mesh(mesh, data_axis=DATA_AXIS, *, ensemble=False):
    """Activate ``mesh`` for the potentials evaluated inside: a
    data-sharded potential evaluates its ranks' shards over ``data_axis``,
    and with ``ensemble=True`` a cross-chain kernel's batched potential
    splits the ensemble's rows over the chains dim.  Entered by the MCMC
    executor around a ``chain_method="parallel"`` run; inert otherwise."""
    prev = dict(_INFERENCE_CTX)
    _INFERENCE_CTX.update(mesh=mesh, data_axis=data_axis,
                          ensemble=bool(ensemble))
    try:
        yield
    finally:
        _INFERENCE_CTX.update(prev)


class MeshShape:
    """A mesh's named dims and their sizes without devices or ranks (the
    pure-logic functions of the LM half take it where a ``DeviceMesh``
    would be): ``MeshShape({"data": 16, "model": 16})``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


def _dims(mesh):
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def dim_size(mesh, dim):
    """The ranks along the mesh dim named ``dim``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape[dim]
    return mesh.shape[_dims(mesh).index(dim)]


def active_data_mesh():
    """``(mesh, data_axis)`` if a mesh with a data dim is active, else
    None."""
    mesh, axis = _INFERENCE_CTX["mesh"], _INFERENCE_CTX["data_axis"]
    if mesh is None or axis is None or axis not in _dims(mesh):
        return None
    return mesh, axis


def active_ensemble_split():
    """``(chains group, rank, ranks)`` when an ensemble's batched potential
    should evaluate only its chain rank's rows (an active mesh entered with
    ``ensemble=True``), else None."""
    mesh = _INFERENCE_CTX["mesh"]
    if mesh is None or not _INFERENCE_CTX["ensemble"]:
        return None
    return (mesh.get_group(CHAIN_AXIS), mesh.get_local_rank(CHAIN_AXIS),
            dim_size(mesh, CHAIN_AXIS))


def active_chain_rows():
    """The chains dim's process group when the active mesh splits a
    per-chain kernel's lockstep batch over it (each chain rank holds its
    block of chains), else None."""
    mesh = _INFERENCE_CTX["mesh"]
    if mesh is None or _INFERENCE_CTX["ensemble"]:
        return None
    return mesh.get_group(CHAIN_AXIS)


def chain_placements(mesh):
    """Per-chain state: rows over ``chains``, replicated over ``data``."""
    return tuple(Shard(0) if d == CHAIN_AXIS else Replicate()
                 for d in _dims(mesh))


def replicated_placements(mesh):
    """Shared (pooled) state: on every rank."""
    return tuple(Replicate() for _ in _dims(mesh))


def data_placements(mesh):
    """Likelihood data rows: rows over ``data``, replicated over
    ``chains``."""
    return tuple(Shard(0) if d == DATA_AXIS else Replicate()
                 for d in _dims(mesh))


def local_block(rows, mesh, placements):
    """``(start, stop)``: this rank's block of ``rows`` rows under
    ``placements`` (a ``Shard(0)`` dim splits the rows evenly in rank
    order); raises when a dim does not divide the rows."""
    start, stop = 0, rows
    for dim, place in zip(_dims(mesh), placements):
        if not isinstance(place, Shard):
            continue
        size, rank = dim_size(mesh, dim), mesh.get_local_rank(dim)
        rows = stop - start
        if rows % size:
            raise ValueError(f"{rows} rows do not split over the {size} "
                             f"ranks of mesh dim {dim!r}")
        start, stop = start + rank * (rows // size), \
            start + (rank + 1) * (rows // size)
    return start, stop


def local_rows(tensor, mesh, placements):
    """This rank's block of ``tensor``'s rows (:func:`local_block`), as a
    contiguous copy."""
    start, stop = local_block(tensor.shape[0], mesh, placements)
    return tensor[start:stop].clone()


def _comm_device(group):
    """Where ``group``'s collectives take their tensors: the current card
    for NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(tensor, group):
    """The ranks' ``tensor``s of ``group`` stacked along dim 0 in rank
    order, on ``tensor``'s device and dtype (every rank gives the same
    shape).  A numpy array comes back as a numpy array."""
    if dist.get_world_size(group) == 1:
        return tensor
    if isinstance(tensor, np.ndarray):
        return all_gather_rows(torch.from_numpy(np.ascontiguousarray(tensor)),
                               group).numpy()
    wire = tensor.to(_comm_device(group))
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    wire = wire.contiguous()
    out = wire.new_empty((dist.get_world_size(group) * wire.shape[0],)
                         + tuple(wire.shape[1:]))
    _GATHER(out, wire, group=group)
    return out.to(device=tensor.device, dtype=tensor.dtype)


def all_gather_pair(values, grads, group):
    """:func:`all_gather_rows` of ``values (R, ...)`` and ``grads (R, ...,
    k)`` in one collective (packed side by side along the last dim)."""
    if dist.get_world_size(group) == 1:
        return values, grads
    packed = all_gather_rows(torch.cat([values.unsqueeze(-1), grads], -1),
                             group)
    return packed[..., 0], packed[..., 1:]


def _is_namedtuple(node):
    return isinstance(node, tuple) and hasattr(node, "_fields")


def map_rows(fn, tree):
    """``fn`` on every array leaf (tensor or numpy array with a leading
    dim) of a nested NamedTuple/dict/list/tuple tree; other leaves kept."""
    if _is_namedtuple(tree):
        return type(tree)(*(map_rows(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_rows(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_rows(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)) and tree.ndim >= 1:
        return fn(tree)
    return tree


def gather_tree(tree, group):
    """Every array leaf of ``tree`` gathered along dim 0 over ``group``."""
    if dist.get_world_size(group) == 1:
        return tree
    return map_rows(lambda t: all_gather_rows(t, group), tree)


def take_rows(tree, start, stop):
    """Rows ``start:stop`` of every array leaf of ``tree``, copied."""
    return map_rows(lambda t: t[start:stop].copy()
                    if isinstance(t, np.ndarray) else t[start:stop].clone(),
                    tree)


def barrier(mesh):
    """Every rank of ``mesh`` has arrived: a barrier over its chains dim,
    then over its data dim (after which every rank of every row has passed
    the first)."""
    for dim in _dims(mesh):
        group = mesh.get_group(dim)
        if dist.get_world_size(group) == 1:
            continue
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)


# ---------------------------------------------------------------------------
# the LM half: logical axis names -> mesh dims -> DTensor placements
# ---------------------------------------------------------------------------

def make_rules(cfg, mesh, seq_parallel: bool = True,
               sp_scoped: bool = False) -> dict:
    """The logical-name rules of ``cfg`` on ``mesh`` (the JAX package's
    dict): the batch over the data-parallel dims (``pod``, ``data``), the
    residual stream's sequence over ``model`` (``seq_parallel``), heads,
    kv heads, the MLP's inner dim and the vocab over ``model``, every
    weight's ``embed`` dim over ``data`` (FSDP).  ``seq_parallel=False``
    keeps the sequence whole; ``sp_scoped`` (and ``seq_parallel=False``)
    adds ``seq_inner -> None``, so block-internal activations gather the
    sequence.  A logical name absent from the rules leaves its constraint
    off (:func:`repro_torch.models.common.logical_to_spec`)."""
    axes = _dims(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    rules = {
        "batch": dp,
        "seq": "model" if seq_parallel else None,
        "embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "vocab": "model",
        "layers": None,
    }
    if sp_scoped or not seq_parallel:
        rules["seq_inner"] = None
    if cfg.moe:
        if big_ep(cfg):
            rules["expert"] = ("data", "model")
            rules["expert_inner"] = None
        else:
            rules["expert"] = ("model",)
            rules["expert_inner"] = "data"
    return rules


def big_ep(cfg) -> bool:
    """Experts >= devices-per-pod / 2: expert parallelism over (data,
    model)."""
    return cfg.num_experts >= 64


def ep_degree_for(cfg) -> int:
    """The expert-parallel degree of the active sharding context (1 off a
    mesh, and for a configuration without experts)."""
    from ..models.common import current_mesh, current_rules
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not cfg.moe:
        return 1
    ep_axes = rules.get("expert") or ()
    if isinstance(ep_axes, str):
        ep_axes = (ep_axes,)
    deg = 1
    for a in ep_axes:
        deg *= dim_size(mesh, a)
    return deg


def _entry(value):
    """One spec entry as ``PartitionSpec`` keeps it: a tuple of one name is
    that name, an empty tuple None."""
    if isinstance(value, (list, tuple)):
        value = tuple(value)
        if not value:
            return None
        return value[0] if len(value) == 1 else value
    return value


def logical_to_partition(logical, rules) -> tuple:
    """Logical axis names (or None) -> a spec tuple, one entry per tensor
    dim (the entries of the JAX package's ``PartitionSpec``)."""
    if logical is None:
        return ()
    return tuple(_entry(rules.get(name)) if name is not None else None
                 for name in logical)


def _axes_size(entry, mesh) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    n = 1
    for a in axes:
        n *= dim_size(mesh, a)
    return n


def divisible_partition(spec, shape, mesh) -> tuple:
    """``spec`` with each entry whose mesh dims do not divide its tensor
    dim dropped (an odd vocab such as 50280 stays replicated)."""
    return tuple(entry if i < len(shape)
                 and shape[i] % _axes_size(entry, mesh) == 0 else None
                 for i, entry in enumerate(spec))


def spec_to_placements(spec, mesh) -> tuple:
    """One DTensor placement per dim of ``mesh``: ``Shard(i)`` where tensor
    dim ``i``'s entry names it (a dim over several mesh dims, such as
    ``("pod", "data")``, is ``Shard(i)`` on each, split in mesh order),
    else ``Replicate()``.  A mesh dim of one rank is ``Replicate()``
    either way, so nothing is ever moved over it."""
    owner = {}
    for i, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            owner[name] = i
    return tuple(Shard(owner[d]) if d in owner and dim_size(mesh, d) > 1
                 else Replicate() for d in _dims(mesh))


def place(x, mesh, placements):
    """``x`` as a DTensor with ``placements`` on ``mesh``: a plain tensor,
    the same on every rank, is taken as replicated first (so a shard is a
    local slice: nothing moves), a DTensor is redistributed (nothing runs
    where it already lies so)."""
    placements = tuple(placements)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def replicate(t):
    """A DTensor with its value whole on every rank (a partial sum or
    mean reduced); a plain tensor as it is.  Reduced scalars are
    replicated before they meet each other: DTensor does not turn one kind
    of partial value into another."""
    if not isinstance(t, DTensor):
        return t
    whole = (Replicate(),) * t.device_mesh.ndim
    return t if tuple(t.placements) == whole \
        else t.redistribute(t.device_mesh, whole)


def whole_seq(x):
    """``x (B, S, ...)`` with its sequence whole on every rank (a DTensor's
    sequence shards gathered, the layout a product of ``x`` with a weight
    needs: DTensor does not flatten ``(B, S)`` with ``S`` split); a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    placements = tuple(Replicate() if isinstance(p, Shard)
                       and p.dim % x.ndim == 1 else p for p in x.placements)
    return x if placements == tuple(x.placements) \
        else x.redistribute(x.device_mesh, placements)


def grad_placements(mesh, split):
    """The gradient placements of an input every rank holds whole and
    uses for work split as ``split`` says: a partial sum over each mesh
    dim of more than one rank that splits the work, else replicated."""
    return tuple(Partial() if isinstance(p, Shard) and mesh.size(i) > 1
                 else Replicate() for i, p in enumerate(split))


class NamedSharding(NamedTuple):
    """Where a tensor lies on ``mesh``: its spec tuple and the DTensor
    placements it gives (:func:`spec_to_placements`)."""
    mesh: object
    spec: tuple
    placements: tuple


def named_sharding(mesh, spec) -> NamedSharding:
    spec = tuple(spec)
    return NamedSharding(mesh, spec, spec_to_placements(spec, mesh))


def _is_spec_leaf(node):
    return node is None or isinstance(node, tuple)


def param_shardings(spec_tree, rules, mesh, shapes=None):
    """A tree of logical names (``LM.abstract_params()[1]``) -> the same
    tree of :class:`NamedSharding`; with ``shapes`` (the matching tree of
    shapes or tensors), a dim its mesh dims do not divide is replicated
    instead."""
    def one(logical, shape=None):
        spec = logical_to_partition(logical, rules)
        if shape is not None:
            spec = divisible_partition(spec, tuple(shape), mesh)
        return named_sharding(mesh, spec)

    def walk(node, shp):
        if isinstance(node, dict):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in node.items()}
        if shp is not None and not isinstance(shp, (tuple, torch.Size)):
            shp = shp.shape
        return one(node, shp)
    return walk(spec_tree, shapes)


def batch_sharding(rules, mesh, ndim=2) -> NamedSharding:
    """Input batches: rows over the data-parallel dims."""
    return named_sharding(mesh, (_entry(rules["batch"]),)
                          + (None,) * (ndim - 1))


def cache_sharding(rules, mesh) -> NamedSharding:
    """KV caches: batch over the data-parallel dims, sequence over
    ``model`` (the flash-decoding layout; no serving path of the port
    takes it yet)."""
    return named_sharding(mesh, (_entry(rules["batch"]), "model"))
