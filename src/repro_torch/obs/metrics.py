"""The metrics stream contract, host side.

A kernel that declares ``KernelSetup.metrics_fn`` promises a function
``state -> dict[str, leaf]`` that only reads the state.  Per-chain kernels
(HMC, NUTS) return scalars for one chain's state and ``(C,)`` leaves for
the lockstep batched state (leaves leading with the chain axis);
cross-chain kernels (ChEES, MALA, RWM, NUTS with ``cross_chain_adapt``)
return scalars (pooled quantities: the shared step size, the trajectory
length) or ``(C,)`` vectors (per-chain quantities: accept prob,
divergence).  The executor evaluates ``metrics_fn`` after every transition
beside the collected draws (never feeding anything back into the state),
so the sample stream is bit-identical with metrics on or off, and drains
the whole chunk's series to the host in **one** device->host read.

This module owns the host side of that contract:

- :func:`host_tree`: a flat dict's device tensors stacked into one float64
  tensor on the device and copied to the host in one counted read (each
  leaf gets its dtype back, bit for bit); host leaves (numpy, Python
  scalars) go in without a copy.
- :func:`metrics_struct` / :func:`validate_metrics_struct`: evaluate
  ``metrics_fn`` on a real state (the kernel's own init on throwaway draw
  sources; there is no abstract tracing in PyTorch) and check the shape
  contract; violations are RPL401 (:mod:`repro_torch.lint_rules.obs_rules`
  and the executor's check on the run's own initial state raise the same
  code).
- :class:`MetricsBuffer`: accumulates the per-chunk metric trees and
  concatenates them into per-phase ``(chains, draws)`` series (pooled
  cross-chain leaves stay ``(draws,)``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def host_tree(tree: dict, reads=None, device=None) -> dict:
    """Host numpy copies of a flat dict's leaves with at most one
    device->host read.

    Tensors on ``device`` (by default the card of the first CUDA tensor,
    else the CPU) are flattened into one contiguous float64 tensor there and
    copied with ``reads.fetch`` (counted; uncounted without ``reads``);
    each comes back reshaped and cast to its own dtype, which float64 holds
    exactly.  Other tensors (a CPU tensor on a card run) and numpy or Python
    leaves are converted without a read."""
    if device is None:
        device = next((v.device for v in tree.values()
                       if isinstance(v, torch.Tensor)
                       and v.device.type != "cpu"), torch.device("cpu"))
    device = torch.device(device)
    out, packed = {}, []
    for name, v in tree.items():
        if isinstance(v, torch.Tensor) and v.device.type == device.type:
            packed.append((name, v))
        elif isinstance(v, torch.Tensor):
            out[name] = v.detach().numpy().copy()
        else:
            out[name] = np.asarray(v)
    if packed:
        flat = torch.cat([v.detach().reshape(-1).to(torch.float64)
                          for _, v in packed])
        host = reads.fetch(flat) if reads is not None \
            else flat.cpu().numpy()
        offset = 0
        for name, v in packed:
            n = v.numel()
            out[name] = host[offset:offset + n].reshape(tuple(v.shape)) \
                .astype(_np_dtype(v.dtype))
            offset += n
    return {name: out[name] for name in tree}


def stack_rows(rows) -> dict:
    """Per-draw metric dicts -> one dict of series, the draw axis last:
    device tensors stacked on the device, host values with numpy."""
    if not rows:
        return {}
    out = {}
    for name in rows[0]:
        values = [row[name] for row in rows]
        if isinstance(values[0], torch.Tensor):
            out[name] = torch.stack(values, dim=-1)
        else:
            out[name] = np.stack([np.asarray(v) for v in values], axis=-1)
    return out


class MetricLeaf(NamedTuple):
    """Shape and dtype of one metrics_fn leaf."""

    shape: tuple
    dtype: str


def lint_state(setup, num_chains: int = 2, batched: bool = False):
    """A real chain state for ``setup``, as ``metrics_fn`` sees it: one
    chain's (per-chain kernels), the lockstep batch of ``num_chains``
    (``batched=True`` and ``setup.init_batch_fn``), or the ensemble
    (cross-chain kernels).  Made by the kernel's own init on throwaway draw
    sources, as the resume skeleton is: its evaluations bump the setup's
    counters, which ``MCMC.stats`` never sees (a run builds its own
    setup)."""
    from ..core.infer.hmc_util import GeneratorDraws

    def sources(n):
        return [GeneratorDraws(torch.Generator().manual_seed(1000 + i))
                for i in range(n)]

    if setup.cross_chain:
        *chain_draws, shared = sources(int(num_chains) + 1)
        return setup.init_fn(chain_draws, shared)
    if batched and setup.init_batch_fn is not None:
        return setup.init_batch_fn(sources(int(num_chains)))
    return setup.init_fn(sources(1)[0])


def struct_of(out: dict) -> dict:
    """Name -> :class:`MetricLeaf` of one metrics_fn output."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return MetricLeaf(tuple(v.shape), str(v.dtype))
        return MetricLeaf(tuple(np.shape(v)), str(np.asarray(v).dtype))

    return {name: leaf(v) for name, v in out.items()}


def metrics_struct(setup, num_chains: int = 2, batched: bool = False):
    """Shape/dtype of ``setup.metrics_fn``'s output on a real state
    (:func:`lint_state`); None when the setup declares no metrics_fn."""
    if setup.metrics_fn is None:
        return None
    return struct_of(setup.metrics_fn(lint_state(setup, num_chains,
                                                 batched)))


def validate_metrics_struct(setup, struct, num_chains: int = 2,
                            batched: bool = False):
    """Shape-contract violations of a metrics output struct, as
    ``(metric_name, shape)`` pairs (empty list = clean).

    Per-chain kernels: every leaf a scalar on one chain's state and
    ``(num_chains,)`` on the lockstep batched state (``batched=True``);
    cross-chain kernels: scalars (pooled) or ``(num_chains,)`` vectors
    (per-chain).  Any other rank would broadcast garbage into the
    buffered series."""
    if struct is None:
        return []
    bad = []
    for name, leaf in struct.items():
        shape = tuple(leaf.shape)
        if setup.cross_chain:
            ok = shape == () or shape == (int(num_chains),)
        elif batched:
            ok = shape == (int(num_chains),)
        else:
            ok = shape == ()
        if not ok:
            bad.append((name, shape))
    return bad


class MetricsBuffer:
    """Host-side accumulator for per-chunk metric trees.

    ``add_chunk`` takes one chunk's stacked metrics (device leaves are
    copied in one read, :func:`host_tree`) and appends them under their
    phase.  ``series`` concatenates the chunks along the draw axis:
    per-chain leaves come out as ``(chains, draws)``, pooled cross-chain
    leaves as ``(draws,)``.
    """

    def __init__(self):
        self._chunks = {"warmup": [], "sample": []}

    def add_chunk(self, phase: str, start: int, end: int, tree,
                  reads=None) -> dict:
        host = host_tree(tree, reads)
        self._chunks[phase].append((int(start), int(end), host))
        return host

    def series(self, phase: str = "sample") -> dict:
        """Concatenated per-metric arrays for ``phase`` (draw axis last)."""
        parts = [tree for _, _, tree in self._chunks[phase]]
        if not parts:
            return {}
        return {k: np.concatenate([p[k] for p in parts], axis=-1)
                for k in parts[0]}

    def num_draws(self, phase: str = "sample") -> int:
        return sum(end - start for start, end, _ in self._chunks[phase])

    def summary(self, phase: str = "sample") -> dict:
        """Scalar per-metric summary (mean over everything and the final
        draw's chain mean): what the manifest records as final
        diagnostics."""
        out = {}
        for name, arr in self.series(phase).items():
            arr = np.asarray(arr, np.float64)
            out[name] = {"mean": float(arr.mean()),
                         "last": float(arr[..., -1].mean())}
        return out

    def clear(self) -> None:
        self._chunks = {"warmup": [], "sample": []}
