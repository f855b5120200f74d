"""Device meshes (the port of the JAX package's ``repro/launch/mesh.py``):
the MCMC executor's (``make_inference_mesh``) and the LM stack's
(``make_production_mesh``, ``make_host_mesh``).

A rank is one process with one device: a card (``cuda``, the default) or
the CPU when the caller asks for it (the tests, with gloo).  Under
``torchrun`` (whose environment starts the group) or any process group
the caller started, the mesh spans its ranks; with neither,
:func:`make_inference_mesh` starts a one-rank group in this process (NCCL on a card, gloo on the CPU, rendezvous through
an in-process store), so ``chain_method="parallel"`` runs in one process on
one card as the JAX package's does on one device.  The LM meshes span the
process group's ranks exactly: a shape whose rank count differs from the
group's raises ``RPL301`` naming the count it needs.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.errors import MESH_SHAPE, ReproValueError
from ..distributed.sharding import CHAIN_AXIS, DATA_AXIS


def _launched():
    """Whether a launcher (``torchrun``) gave this process its rank in the
    environment."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def _world():
    """The rank count a mesh can take before any group is started."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _launched() else 1


def _ranks(device_type):
    """The ranks a mesh can take: the process group's, after starting one
    when there is none (from ``torchrun``'s environment, else a one-rank
    group in this process)."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if _launched():
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dist.get_world_size()


def _lm_mesh(shape, axes, devices):
    """A ``DeviceMesh`` of ``shape`` with dims ``axes`` over every rank of
    the process group (a one-rank group started in process when there is
    none), in row-major order."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ReproValueError(f"mesh shape {shape} does not fit the dims "
                              f"{axes}", code=MESH_SHAPE)
    need = 1
    for n in shape:
        need *= n
    have = _world()
    if need != have:
        raise ReproValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {need} ranks, one "
            f"device each, but the process group has {have}: start {need} "
            "ranks (torchrun --nproc-per-node "
            f"{need}) or pick a shape of {have}.", code=MESH_SHAPE)
    device_type = torch.device(devices or "cuda").type
    _ranks(device_type)
    return DeviceMesh(device_type, torch.arange(need).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, *, devices=None):
    """The production mesh: ``(data=16, model=16)``, 256 ranks, or with
    ``multi_pod`` ``(pod=2, data=16, model=16)``, 512 ranks, where ``pod``
    carries only the data-parallel gradient reductions."""
    if multi_pod:
        return _lm_mesh((2, 16, 16), ("pod", "data", "model"), devices)
    return _lm_mesh((16, 16), ("data", "model"), devices)


def make_host_mesh(shape=None, axes=("data", "model"), *, devices=None):
    """A mesh over the process group's ranks (tests, examples, the
    launcher's ``--mesh``): ``shape`` by default ``(n // 2, 2)`` for an
    even ``n > 1`` ranks, else ``(n, 1)``; ``devices`` is the device type,
    ``"cuda"`` (default) or ``"cpu"``."""
    if shape is None:
        n = _world()
        shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    return _lm_mesh(shape, axes, devices)


def make_inference_mesh(num_chains, mesh_shape=None, *, devices=None):
    """Mesh for ``chain_method="parallel"``: a ``DeviceMesh`` over the
    process group's ranks 0, 1, ... in row-major order.

    ``mesh_shape=None`` gives the 1-D ``("chains",)`` mesh over the largest
    rank count that divides ``num_chains``; ``(Sc, Sd)`` the 2-D
    ``("chains", "data")`` mesh.  A rank outside the mesh takes no chains
    (its coordinate is None).  ``devices`` is the device type, ``"cuda"``
    (default) or ``"cpu"``.  Every rank of the process group must call it
    (the mesh's sub-groups are made collectively).

    Raises ``ReproValueError`` ``RPL301`` when the shape does not fit: a
    dim below 1, a chain count the chain dim does not divide (every rank
    must own the same number of whole chains, or the sample streams could
    not stay bit-identical across layouts), or more slots than ranks.
    """
    device_type = torch.device(devices or "cuda").type
    if mesh_shape is not None:
        chains_ax, data_ax = (int(v) for v in mesh_shape)
        if chains_ax < 1 or data_ax < 1:
            raise ReproValueError(
                f"mesh_shape={mesh_shape} is not a valid (chains, data) "
                "shape", code=MESH_SHAPE)
        if num_chains % chains_ax != 0:
            raise ReproValueError(
                f"num_chains={num_chains} is not divisible by the mesh "
                f"chain axis ({chains_ax}): every device must own the same "
                "number of whole chains for sample streams to stay "
                "bit-identical across layouts. Pick a chain axis that "
                "divides the chain count.", code=MESH_SHAPE)
        if dist.is_initialized() and chains_ax * data_ax > \
                dist.get_world_size():
            raise ReproValueError(
                f"mesh_shape={mesh_shape} needs {chains_ax * data_ax} "
                f"devices but only {dist.get_world_size()} are visible.",
                code=MESH_SHAPE)
        if not dist.is_initialized() and chains_ax * data_ax > 1:
            raise ReproValueError(
                f"mesh_shape={mesh_shape} needs {chains_ax * data_ax} "
                "devices but only 1 is visible (no process group: start "
                "the ranks with torchrun).", code=MESH_SHAPE)
    ranks = _ranks(device_type)
    if mesh_shape is None:
        use = max(k for k in range(1, ranks + 1) if num_chains % k == 0)
        return DeviceMesh(device_type, torch.arange(use),
                          mesh_dim_names=(CHAIN_AXIS,))
    return DeviceMesh(device_type,
                      torch.arange(chains_ax * data_ax).view(chains_ax,
                                                             data_ax),
                      mesh_dim_names=(CHAIN_AXIS, DATA_AXIS))
