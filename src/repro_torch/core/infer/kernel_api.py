"""The sampler kernel contract.

A sampler is exposed as an ``init`` that produces a chain state and a
``sample`` that maps state to state, with every static ingredient (potential
closure, unravel, constrain, adaptation schedule) captured once in a
:class:`KernelSetup`.  Unlike the JAX package, randomness is not a key in the
state: ``init_fn`` and ``sample_fn`` take a *draw source* (see
``hmc_util.GeneratorDraws``), one per chain, so a test can inject another
implementation's draws.

A *cross-chain* setup (``cross_chain=True``: ChEES, MALA, RWM) moves the
whole ensemble at once: ``init_fn(chain_draws, draws)`` takes one draw
source per chain (for each chain's initial-point search) and the shared
source, ``sample_fn(state, draws)`` maps the ensemble state with the shared
source, and ``collect_fn`` returns leaves that lead with the chain axis.
HMC/NUTS with ``cross_chain_adapt=True`` is cross-chain too, but every chain
keeps its own source: its ``sample_fn(state, chain_draws)`` takes them all.

A per-chain kernel that can move C chains in lockstep (HMC, NUTS) also
gives ``init_batch_fn(chain_draws)`` and ``sample_batch_fn(state,
chain_draws)``: the batched state's leaves lead with the chain axis, each
chain draws from its own source what it would draw alone, and
``sample_batch_fn.lockstep.leapfrogs`` counts the lockstep leapfrogs.

``metrics_fn`` (optional) is the metrics stream ``repro_torch.obs`` drains
once per chunk.

:class:`SamplerKernel` is the protocol the executor drives: ``setup`` and
``init``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Protocol, Tuple, \
    runtime_checkable


class KernelSetup(NamedTuple):
    """Static, closure-carrying companion of a chain state."""

    init_fn: Callable          # draws -> state (see cross_chain)
    sample_fn: Callable        # (state, draws) -> state
    # state -> dict of per-draw outputs ("z" plus diagnostics)
    collect_fn: Callable
    potential_fn: Callable     # flat (D,) -> scalar potential energy
    unravel_fn: Callable       # flat (..., D) -> latent dict (unconstrained)
    constrain_fn: Callable     # flat (..., D) -> latent dict (constrained)
    num_warmup: int
    algo: str                  # "HMC" | "NUTS" | "ChEES" | "MALA" | "RWM"
    adapt_schedule: Tuple[Tuple[int, int], ...]  # Stan-style (start, end)
    # the sampler's device->host reads (hmc_util.HostReads): on a card,
    # each is a host sync
    host_reads: object = None
    # the potential as the sampler calls it, counting its value-and-gradient
    # evaluations in ``.count``
    grad_evals: object = None
    # batch-aware kernel: init/sample move the (C, ...) ensemble together
    cross_chain: bool = False
    # C chains in lockstep (HMC/NUTS): chain_draws -> batched state, and
    # (batched state, chain_draws) -> batched state
    init_batch_fn: Optional[Callable] = None
    sample_batch_fn: Optional[Callable] = None
    # the metrics stream: state -> dict of leaves, read from the state only
    # (it must not draw, write a leaf in place, or return a view of a
    # buffer the next transition writes).  Per-chain kernels return scalars
    # for one chain's state and (C,) leaves for the lockstep batched state;
    # cross-chain kernels scalars (pooled) or (C,) vectors.  The executor
    # evaluates it after each transition when telemetry asks for metrics
    # and drains a chunk's series in one read (repro_torch.obs); RPL401 and
    # RPL402 guard the contract.  None opts out.
    metrics_fn: Optional[Callable] = None
    # "data" when the potential carries a static data_shards fold (the
    # fused GLM potential's ``data_shards`` marker): under
    # chain_method="parallel" the mesh's data ranks evaluate its shards.
    # The setup stays mesh-agnostic; the executor activates the mesh.
    data_axis: Optional[str] = None


def init_state(setup: KernelSetup, *draws):
    """State init: ``draws`` of one chain, or for a cross-chain setup the
    per-chain sources and the shared one."""
    return setup.init_fn(*draws)


def sample(setup: KernelSetup, state, draws):
    """One transition ``state -> state`` under ``setup``."""
    return setup.sample_fn(state, draws)


def collect(setup: KernelSetup, state):
    """Per-draw outputs (position + diagnostics) recorded by the executor."""
    return setup.collect_fn(state)


def metrics(setup: KernelSetup, state):
    """One metrics-stream sample (None when the kernel declares no
    ``metrics_fn``): what the executor records after a transition when
    telemetry asks for metrics."""
    if setup.metrics_fn is None:
        return None
    return setup.metrics_fn(state)


@runtime_checkable
class SamplerKernel(Protocol):
    """Anything the multi-chain executor can drive.

    ``setup`` does the one-time work and returns the :class:`KernelSetup`
    whose ``init_fn``/``sample_fn`` are the pair above; ``init`` bundles
    both steps and returns an initial state.
    """

    def setup(self, generator, num_warmup, init_params=None, model_args=(),
              model_kwargs=None) -> KernelSetup:
        ...

    def init(self, generator, num_warmup, init_params=None, model_args=(),
             model_kwargs=None) -> Any:
        ...
