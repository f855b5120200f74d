"""RPL4xx: the metrics-stream contract and the stopping rule behind
``repro_torch.obs``.

Over a :class:`~repro_torch.core.infer.kernel_api.KernelSetup` that
declares ``metrics_fn``, evaluated on a real state (there is no abstract
tracing in PyTorch): the lint entry :func:`verify_metrics_fn` makes one
with the kernel's own init on throwaway draw sources; ``MCMC.run`` checks
the run's own initial state before the first transition
(:func:`check_metrics_state`), with no extra init.

- **RPL401**, shape contract: per-chain kernels return scalars for one
  chain's state and ``(C,)`` leaves for the lockstep batched state;
  cross-chain kernels scalars (pooled) or ``(C,)`` vectors.  Anything else
  would broadcast garbage into the buffered series.
- **RPL402**, no randomness: the port's state holds no key (draws come
  from separate sources), so the JAX package's taint over a jaxpr has no
  subject.  Instead ``metrics_fn`` is evaluated twice on the same state
  under ``torch.random.fork_rng``, the global CPU and card generators
  seeded differently each time; a leaf whose bits differ consumed
  randomness.  When neither evaluation moved a generator no leaf can
  differ and no leaf is read, so the clean case costs the executor no
  host sync.
- **RPL403**, :func:`verify_until`: a ``Converged`` rule that can never
  fire for the run's geometry (the JAX package's checks and messages).
"""
from __future__ import annotations

import numpy as np
import torch

from . import ERROR


def _mk(code, site, message):
    from ..core.lint import Finding
    return Finding(code, ERROR, site, message)


def _result(findings):
    from ..core.lint import LintResult
    return LintResult(findings)


def _generator_states(devices):
    return [torch.get_rng_state()] + [torch.cuda.get_rng_state(d)
                                      for d in devices]


def _evaluate(metrics_fn, state, seed):
    """``metrics_fn(state)`` with the global generators seeded to ``seed``
    and restored afterwards; returns ``(out, moved)``, ``moved`` whether
    the evaluation drew from a generator."""
    devices = list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        before = _generator_states(devices)
        out = metrics_fn(state)
        moved = not all(torch.equal(a, b) for a, b in zip(
            before, _generator_states(devices)))
    return out, moved


def _same_bits(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.detach().contiguous().reshape(-1).view(torch.uint8),
            b.detach().contiguous().reshape(-1).view(torch.uint8))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def check_metrics_state(setup, state, num_chains: int,
                        batched: bool = False) -> list:
    """RPL401 and RPL402 findings of ``setup.metrics_fn`` on ``state``:
    one chain's state, the lockstep batch (``batched=True``) or, for a
    cross-chain setup, the ensemble."""
    from ..obs.metrics import validate_metrics_struct, struct_of
    out, moved_a = _evaluate(setup.metrics_fn, state, 0)
    findings = []
    if setup.cross_chain:
        contract = f"scalar (pooled) or ({num_chains},) per-chain leaves"
    elif batched:
        contract = (f"({num_chains},) leaves on the lockstep batched state "
                    "(one scalar per chain)")
    else:
        contract = "scalar leaves on one chain's state"
    for name, shape in validate_metrics_struct(setup, struct_of(out),
                                               num_chains, batched):
        findings.append(_mk(
            "RPL401", name,
            f"metrics_fn leaf '{name}' has shape {shape}; the "
            f"{'cross-chain' if setup.cross_chain else 'per-chain'} "
            f"metrics contract requires {contract}: other ranks would "
            "broadcast through the chunk's stacked series and corrupt the "
            "buffered metrics. Reduce the leaf (mean/trace/norm) inside "
            "metrics_fn."))
    again, moved_b = _evaluate(setup.metrics_fn, state, 1)
    if moved_a or moved_b:
        for name in out:
            if not _same_bits(out[name], again.get(name)):
                findings.append(_mk(
                    "RPL402", name,
                    f"metrics_fn leaf '{name}' changes with the global "
                    "random generators' seed: metrics must observe the "
                    "chain, never consume randomness (a draw inside "
                    "metrics_fn would have to perturb the sample stream to "
                    "be reflected in it, violating the metrics-on/off "
                    "bit-identity invariant). Derive the metric from the "
                    "state only."))
    return findings


def verify_metrics_fn(setup, num_chains: int = 2):
    """RPL401 + RPL402 over one setup's ``metrics_fn`` (clean result when
    the setup declares none): on one chain's state and, for a kernel that
    moves chains in lockstep, on the batch of ``num_chains``; on the
    ensemble for a cross-chain kernel.  A leaf's finding is reported
    once."""
    if setup.metrics_fn is None:
        return _result([])
    from ..obs.metrics import lint_state
    cases = [False]
    if not setup.cross_chain and setup.init_batch_fn is not None:
        cases.append(True)
    findings, seen = [], set()
    for batched in cases:
        state = lint_state(setup, num_chains, batched)
        for f in check_metrics_state(setup, state, num_chains, batched):
            if (f.code, f.site) not in seen:
                seen.add((f.code, f.site))
                findings.append(f)
    return _result(findings)


def verify_until(until, *, num_samples: int, num_chains: int):
    """RPL403: a :class:`~repro_torch.obs.monitor.Converged` stopping rule
    that can never fire for the run's geometry.

    A gated run that cannot possibly satisfy (or even evaluate) its
    thresholds silently degenerates into a fixed-length run that *looks*
    convergence-checked, worse than no gate.  ``MCMC.run(..., until=...)``
    checks it before the first transition (the runtime twin):

    - ``min_ess`` above the total draw budget ``cap x num_chains``;
    - ``max_rhat`` below 1 (split R-hat converges to 1 from above);
    - a draw budget that never completes the two accumulator batches per
      half-stream that the streaming estimators need (``cap <
      4 x batch_size``), so every gate check would see NaN;
    - degenerate knobs: no thresholds at all, ``batch_size < 2``,
      ``check_every < 1``, ``max_samples < 1``.
    """
    findings = []

    def bad(msg):
        findings.append(_mk("RPL403", None, msg))

    cap = (int(until.max_samples) if until.max_samples is not None
           else int(num_samples))
    budget = cap * int(num_chains)
    if until.max_rhat is None and until.min_ess is None:
        bad("Converged sets no thresholds (max_rhat=None, min_ess=None): "
            "the gate would stop after the first checked chunk regardless "
            "of mixing. Set at least one threshold, or drop until=.")
    if until.max_samples is not None and until.max_samples < 1:
        bad(f"max_samples={until.max_samples} leaves no draw budget.")
    if until.batch_size < 2:
        bad(f"batch_size={until.batch_size} cannot form a variance "
            "estimate; use at least 2 (ideally well above the expected "
            "autocorrelation time).")
    if until.check_every < 1:
        bad(f"check_every={until.check_every} must be a positive chunk "
            "length.")
    if until.max_rhat is not None and until.max_rhat < 1.0:
        bad(f"max_rhat={until.max_rhat} is below 1: split R-hat "
            "approaches 1 from above as chains mix, so the gate can never "
            "fire. Typical thresholds are 1.01-1.05.")
    if until.min_ess is not None and cap >= 1 and until.min_ess > budget:
        bad(f"min_ess={until.min_ess} exceeds the total draw budget "
            f"max_samples x chains = {cap} x {num_chains} = {budget}: "
            "effective sample size cannot reach the threshold. Raise "
            "max_samples/chains or lower min_ess.")
    if cap >= 1 and until.batch_size >= 2 and cap < 4 * until.batch_size:
        bad(f"the draw budget ({cap}) never completes the 4 accumulator "
            f"batches (batch_size={until.batch_size}) the streaming "
            "split R-hat needs (two per half-stream): every gate check "
            "would see NaN diagnostics. Lower batch_size or raise the "
            "budget.")
    return _result(findings)


__all__ = ["check_metrics_state", "verify_metrics_fn", "verify_until"]
