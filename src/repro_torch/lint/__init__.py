"""``repro_torch.lint``: the static analyzer's public face (the JAX
package's ``repro.lint``).

Python API (from :mod:`repro_torch.core.lint` and
:mod:`repro_torch.lint_rules`)::

    from repro_torch.lint import lint_model, analyze
    result = lint_model(model, (x,), {"y": y}, device="cuda")
    result.raise_if_errors()

CLI::

    python -m repro_torch.lint path.py:model --factory path.py:make_args
    python -m repro_torch.lint --corpus --device cpu

The rule registry is :data:`RULES` (:mod:`repro_torch.lint_rules`).
"""
from ..core.lint import (Finding, LintResult, analyze,
                         check_time_independence, count_eqns, lint_model)
from ..lint_rules import RULES, Rule, rule
from ..lint_rules.invariants import (check_parity,
                                     check_registry_completeness,
                                     check_signatures, verify_kernel_setup,
                                     verify_registry)
from ..lint_rules.obs_rules import rng_dependent_metrics, verify_metrics_fn

__all__ = [
    "Finding",
    "LintResult",
    "RULES",
    "Rule",
    "analyze",
    "check_parity",
    "check_registry_completeness",
    "check_signatures",
    "check_time_independence",
    "count_eqns",
    "lint_model",
    "rng_dependent_metrics",
    "rule",
    "verify_kernel_setup",
    "verify_metrics_fn",
    "verify_registry",
]
