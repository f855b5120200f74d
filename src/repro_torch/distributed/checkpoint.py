"""Checkpoint save/restore (the port of ``repro/distributed/checkpoint.py``).

The on-disk format is the JAX package's: one ``.npy`` per leaf of the tree
plus a ``manifest.json`` holding ``step``, ``extra`` and ``leaves: {key:
{file, shape, dtype, kind}}``.  A leaf's key joins its path: a dict key, a
NamedTuple field name, a sequence index, joined by ``/`` (``/`` becomes
``__`` in the file name); dicts are walked in sorted key order and ``None``
is an empty subtree, as ``jax.tree_util`` flattens them.  ``kind`` is the
port's addition (the JAX package's ``restore`` reads only ``file`` and
``dtype``), so each package restores the other's checkpoints.  bfloat16
is written as the JAX package writes it: a ``'<V2'`` npy holding the raw
bits, manifest dtype ``"bfloat16"``.

The tree is nested ``dict``/``list``/``tuple``/NamedTuple with leaves
``torch.Tensor``, ``np.ndarray``, numpy scalars and Python
``int``/``float``/``bool``.  :func:`restore` gives every leaf back as the
type of the matching ``tree_like`` leaf: a tensor with that leaf's dtype
and device (or ``device=``), a numpy array or scalar of its dtype, a
Python ``int``/``float``/``bool``.  A leaf whose dtype, shape or kind
differs from the checkpoint's raises; nothing is cast.  The samplers'
float32 host scalars therefore come back as ``np.float32``, so a resumed
run repeats the uninterrupted one's arithmetic.

Writes are atomic: the checkpoint is written to a temporary directory
beside ``directory`` and renamed over it, so a writer killed mid-write
never corrupts the last complete checkpoint.

Elastic resume (docs/distributed.md's contract): every leaf is saved in
its logical (unsharded) layout, and under ``chain_method="parallel"`` rank
0 writes what a one-process run writes, byte for byte, so an MCMC run
checkpointed on one inference mesh (four ranks on ``mesh_shape=(2, 2)``,
say) resumes under any other mesh or under ``"vectorized"`` in one process:
the executor restores the whole state and each chain rank takes its block
of chains.  The continuation is bit-identical as long as the new chain axis
divides the chains (``RPL301`` otherwise) and the new data axis divides the
potential's static ``data_shards`` fold (``RPL303``).

The LM's train state on a mesh has DTensor leaves: :func:`save` gathers
each to its full value on every rank, rank 0 writes the same files as an
unsharded save, and the mesh's ranks meet at a barrier after it.
:func:`restore` places a leaf on the current mesh by ``shardings=`` (a tree
of ``sharding.NamedSharding``, which may cover part of the tree), else a
leaf whose ``tree_like`` is a DTensor by that DTensor's placements: a
state saved on one mesh resumes on another, or on none.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

_BF16 = "bfloat16"


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, path, out):
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), out)
    elif _is_namedtuple(node):
        for name in node._fields:
            _walk(getattr(node, name), path + (name,), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (str(i),), out)
    elif isinstance(node, (torch.Tensor, np.ndarray, np.generic, bool, int,
                           float)):
        out["/".join(path)] = node
    else:
        raise TypeError(f"checkpoint leaf '{'/'.join(path)}' has type "
                        f"{type(node).__name__}")


def _flatten(tree) -> dict:
    """``{key: leaf}`` in ``jax.tree_util``'s leaf order."""
    out = {}
    _walk(tree, (), out)
    return out


def _rebuild(node, leaves):
    """``node``'s structure holding the next values of ``leaves``."""
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _rebuild(node[k], leaves) for k in sorted(node)}
        return {k: built[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(v, leaves) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaves) for v in node)
    return next(leaves)


def _kind(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, np.ndarray):
        return "ndarray"
    if isinstance(leaf, np.generic):
        return "numpy_scalar"
    if isinstance(leaf, bool):
        return "bool"
    return "int" if isinstance(leaf, int) else "float"


def _dtype_name(leaf) -> str:
    """The manifest dtype a leaf is written with."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> list:
    return list(getattr(leaf, "shape", ()))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.uint16)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _save_leaf(path, leaf):
    arr = _to_numpy(leaf)
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        # the JAX package's ml_dtypes bfloat16 array: raw 2-byte words
        arr = np.ascontiguousarray(arr)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(arr.tobytes())
    else:
        np.save(path, arr)


def save(tree: Any, directory: str, *, step: int = 0,
         extra: Optional[dict] = None) -> None:
    """Atomically write ``tree`` to ``directory`` (a tmpdir beside it, then
    a rename: a preempted writer never corrupts the latest complete
    checkpoint).  DTensor leaves are gathered whole on every rank of their
    mesh (every rank calls ``save``), rank 0 writes, and the ranks meet at
    a barrier after it."""
    flat = _flatten(tree)
    meshes = [leaf.device_mesh for leaf in flat.values()
              if isinstance(leaf, DTensor)]
    if meshes:
        from .sharding import barrier
        flat = {k: v.full_tensor() if isinstance(v, DTensor) else v
                for k, v in flat.items()}
        if dist.get_rank() == 0:
            _write(flat, directory, step, extra)
        barrier(meshes[0])
        return
    _write(flat, directory, step, extra)


def _write(flat, directory, step, extra):
    parent = os.path.dirname(directory) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent)
    try:
        manifest = {"step": int(step), "extra": extra or {}, "leaves": {}}
        for key, leaf in flat.items():
            fname = key.replace("/", "__") + ".npy"
            _save_leaf(os.path.join(tmp, fname), leaf)
            manifest["leaves"][key] = {
                "file": fname, "shape": _shape(leaf),
                "dtype": _dtype_name(leaf), "kind": _kind(leaf)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(directory: str) -> Optional[int]:
    """The step of the checkpoint in ``directory``, None if there is none."""
    mf = os.path.join(directory, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def _load_leaf(directory, key, meta, like, device):
    arr = np.load(os.path.join(directory, meta["file"]))
    if arr.dtype.kind == "V":  # bfloat16 (ml_dtypes) loads as raw void
        if meta["dtype"] != _BF16:
            raise ValueError(f"checkpoint leaf '{key}' holds raw "
                             f"{arr.dtype} words of dtype {meta['dtype']}, "
                             "which the port cannot read")
        arr = arr.view(np.uint16)
    want = (_dtype_name(like), _shape(like))
    got = (meta["dtype"], list(arr.shape))
    if got != want or list(meta["shape"]) != got[1]:
        raise ValueError(f"checkpoint leaf '{key}' is {got[0]} of shape "
                         f"{got[1]}, the tree wants {want[0]} of shape "
                         f"{want[1]}")
    kind = _kind(like)
    if meta.get("kind", kind) != kind:
        raise ValueError(f"checkpoint leaf '{key}' was saved as a "
                         f"{meta['kind']}, the tree wants a {kind}")
    if kind == "tensor":
        t = torch.from_numpy(arr)
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device if device is not None else like.device)
    if kind == "ndarray":
        return arr
    if kind == "numpy_scalar":
        return arr[()]
    return {"bool": bool, "int": int, "float": float}[kind](arr[()])


def _sharding_leaves(node, path=(), out=None):
    """``{key: NamedSharding}`` of a shardings tree, keyed as
    :func:`_flatten` keys the tree it covers."""
    from .sharding import NamedSharding
    out = {} if out is None else out
    if isinstance(node, NamedSharding):
        out["/".join(path)] = node
    elif isinstance(node, dict):
        for k in node:
            _sharding_leaves(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)) and not _is_namedtuple(node):
        for i, v in enumerate(node):
            _sharding_leaves(v, path + (str(i),), out)
    return out


def restore(tree_like: Any, directory: str, *, device=None,
            shardings: Any = None):
    """Restore into the structure of ``tree_like``, each leaf of the type,
    dtype and shape of the matching ``tree_like`` leaf; tensors go to
    ``device``, else to their ``tree_like`` leaf's device.  ``shardings``
    (the tree's shape, or part of it) places each leaf it covers on the
    current mesh, and a leaf whose ``tree_like`` is a DTensor follows its
    placements: the elastic path.

    Returns ``(tree, step, extra)``.
    """
    from .sharding import place
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    placed = _sharding_leaves(shardings) if shardings is not None else {}
    loaded = []
    for key, like in _flatten(tree_like).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        leaf = _load_leaf(directory, key, meta, like, device)
        if key in placed:
            mesh, placements = placed[key].mesh, placed[key].placements
        elif isinstance(like, DTensor):
            mesh, placements = like.device_mesh, like.placements
        else:
            mesh = None
        if mesh is not None:
            leaf = place(leaf.to(mesh.device_type), mesh, placements)
        loaded.append(leaf)
    tree = _rebuild(tree_like, iter(loaded))
    return tree, manifest["step"], manifest["extra"]
