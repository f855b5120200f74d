"""The MCMC executor's device mesh (``make_inference_mesh`` of the JAX
package's ``repro/launch/mesh.py``).

A rank is one process with one device: a card (``cuda``, the default) or
the CPU when the caller asks for it (the tests, with gloo).  Under
``torchrun`` or any process group the caller started, the mesh spans its
ranks; with no process group, :func:`make_inference_mesh` starts a one-rank
group in this process (NCCL on a card, gloo on the CPU, rendezvous through
an in-process store), so ``chain_method="parallel"`` runs in one process on
one card as the JAX package's does on one device.  The production and host
meshes of the LM stack wait for the LM slice of the multi-GPU port.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.errors import MESH_SHAPE, ReproValueError
from ..distributed.sharding import CHAIN_AXIS, DATA_AXIS


def _ranks(device_type):
    """The ranks a mesh can take: the process group's, after starting a
    one-rank group in this process when there is none."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


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
