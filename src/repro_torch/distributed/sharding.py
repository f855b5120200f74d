"""Inference-mesh placements and collectives (the inference half of the JAX
package's ``repro/distributed/sharding.py``).

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
:func:`active_chain_rows`.  The LM
rules (``make_rules``, parameter and batch placements) wait for the LM
slice of the multi-GPU port.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

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


def _dims(mesh):
    return tuple(mesh.mesh_dim_names or ())


def dim_size(mesh, dim):
    """The ranks along the mesh dim named ``dim``."""
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
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group,
                         device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)
