"""Rule registry for the port's static checks (``RPL###`` codes, shared
with the runtime through :mod:`repro_torch.core.errors`).

This slice registers the observability family, ``RPL4xx``
(:mod:`repro_torch.lint_rules.obs_rules`): the ``KernelSetup.metrics_fn``
stream contract (shape discipline, no randomness) and the ``Converged``
stopping rule behind ``repro_torch.obs``.  Each :class:`Rule` declares its
*runtime twin*: ``twin="error"`` means ``MCMC.run`` raises the same code
for the same defect, before the first transition.
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
    # -- RPL4xx: observability/metrics-stream rules ------------------------
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


__all__ = ["ERROR", "WARN", "RULES", "Rule"]
