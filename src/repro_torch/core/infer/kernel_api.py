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
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple


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
