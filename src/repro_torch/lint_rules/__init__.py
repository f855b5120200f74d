"""Rule registry for the port's static analyzer (``RPL###`` codes, shared
with the runtime through :mod:`repro_torch.core.errors`).

The JAX package's four families, with the same codes, severities and
runtime twins:

- ``RPL0xx``: model rules, found by tracing the model once with the inert
  enumeration probe (:func:`repro_torch.core.lint.lint_model`); every coded
  error or warning the runtime raises during that trace becomes a finding
  with the same code.
- ``RPL1xx``: hazard rules over the aten ops that one execution of a
  function dispatches (:func:`repro_torch.core.lint.analyze`), where the
  JAX package reads a jaxpr's equations.
- ``RPL2xx``: the op registry (:mod:`repro_torch.lint_rules.invariants`
  over ``kernels/ops.py``'s ``OP_TABLE``, ``FUSED`` and ``BACKWARD``: each
  hand-written kernel against its plain version on the card) and the
  ``KernelSetup`` field contract.
- ``RPL4xx``: the ``KernelSetup.metrics_fn`` stream contract and the
  ``Converged`` stopping rule (:mod:`repro_torch.lint_rules.obs_rules`),
  which ``MCMC.run`` also checks before the first transition.

Each :class:`Rule` declares its *runtime twin*: ``twin="error"`` /
``"warning"`` means the runtime raises or warns with the same code;
``twin=None`` carries a ``justification`` for staying silent at runtime.
A title or justification differs from the JAX package's only where the
port's reason differs (RPL010, RPL015, RPL1xx, RPL201-204).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

ERROR = "error"
WARN = "warn"


class Rule(NamedTuple):
    code: str
    title: str
    severity: str                       # default severity of findings
    twin: Optional[str]                 # "error" | "warning" | None
    justification: str = ""             # required when twin is None


RULES = {r.code: r for r in [
    # -- RPL0xx: model rules -------------------------------------------------
    Rule("RPL001", "duplicate site name in one trace", ERROR, "error"),
    Rule("RPL002", "plate dim collision with an enclosing plate", ERROR,
         "error"),
    Rule("RPL003", "enumeration dim budget overflow vs max_plate_nesting",
         ERROR, "error"),
    Rule("RPL004", "sample/obs shape does not broadcast against its plate "
         "frame", ERROR, "error"),
    Rule("RPL005", "observed value outside the site's constraint support",
         ERROR, "error"),
    Rule("RPL006", "substitute/condition/do targets a nonexistent site",
         ERROR, "error"),
    Rule("RPL007", "handler targets a reparam-rewritten deterministic site",
         ERROR, "error"),
    Rule("RPL008", "handler targets an enumerated site", ERROR, "error"),
    Rule("RPL009", "unseeded latent sample reached evaluation", ERROR,
         "error"),
    Rule("RPL010", "float64 value entering a float32 model (silent "
         "promotion)", WARN, None,
         "MCMC keeps a float64 numpy array float64 when it moves the model "
         "arguments to the device (mcmc._to_device), so the site's "
         "log-density, the potential and its gradient are silently promoted "
         "to float64 — a valid program, by design with no runtime error "
         "site to attach a code to"),
    Rule("RPL011", "replay of a site recorded as observed but latent here",
         ERROR, "error"),
    Rule("RPL012", "subsampled plate traced without a generator "
         "(deterministic arange fallback)", WARN, "warning"),
    Rule("RPL013", "enumerate mark on a non-enumerable (continuous) site",
         ERROR, "error"),
    Rule("RPL014", "markov combinator inside an active plate", ERROR,
         "error"),
    Rule("RPL015", "handler state baked into the model callable "
         "(a seed generator captured at construction)", WARN, None,
         "a seed handler in the model chain draws from the generator it "
         "captured when it was built, not from the sampler's draw sources: "
         "its draws are invisible to the run's seed and to "
         "checkpoint/resume, which breaks the bit-identity of a resumed or "
         "re-seeded run — the runtime cannot tell that from intended reuse "
         "(global rule: handler state is made inside the model call)"),
    # -- RPL1xx: hazard rules over the dispatched aten ops -------------------
    Rule("RPL101", "large tensor closed over by the function (not an "
         "argument, not made in the call)", WARN, None,
         "a closed-over tensor is a valid program; only the analyzer sees "
         "which tensors the call reads that it was not given"),
    Rule("RPL102", "device->host read on the hot path", WARN, None,
         "a host read (.item(), a copy to the CPU, a data-dependent shape) "
         "is a legal op; hotness is a property of the call site"),
    Rule("RPL103", "precision-losing dtype conversion inside the function",
         WARN, None,
         "dtype conversions are silent by design in PyTorch programs"),
    Rule("RPL104", "op count grows with the time axis (markov elimination "
         "must be T-independent)", ERROR, None,
         "op-count growth is only observable by recording the function at "
         "two sizes — there is no single-run runtime signal"),
    # -- RPL2xx: kernel registry and KernelSetup invariants ------------------
    Rule("RPL201", "op missing its kernel or plain-version registry entry",
         ERROR, None,
         "registry completeness is a repo invariant, not a runtime event"),
    Rule("RPL202", "wrapper/kernel/plain-version signature mismatch for a "
         "registered op", ERROR, None,
         "signatures are static properties of the source"),
    Rule("RPL203", "hand-written kernel disagrees with its plain version "
         "on the card", ERROR, None,
         "parity is verified by execution on the card in the registry "
         "harness, not raised by the dispatch layer"),
    Rule("RPL204", "KernelSetup field contract violation", ERROR, None,
         "the contract is checked by the registry harness; a bad field "
         "fails later in the executor with an error that carries no code"),
    # -- RPL4xx: observability/metrics-stream rules --------------------------
    # (the runtime twin is MCMC.run's check on the run's own initial state)
    Rule("RPL401", "metrics_fn leaf violates the shape contract (scalar "
         "per-chain; scalar or (num_chains,) cross-chain)", ERROR, "error"),
    Rule("RPL402", "metrics_fn output depends on the global random "
         "generators (metrics must observe the chain, never consume "
         "randomness)", ERROR, "error"),
    Rule("RPL403", "Converged stopping rule unsatisfiable for the run "
         "geometry (min_ess above the draw budget, max_rhat below 1, or a "
         "batch size the budget can never fill)", ERROR, "error"),
]}


def rule(code: str) -> Rule:
    return RULES[code]


__all__ = ["ERROR", "WARN", "RULES", "Rule", "rule"]
