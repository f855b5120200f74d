"""Lint results (``RPL###`` findings), the JAX package's ``Finding`` and
``LintResult``.

The rules that produce them live in :mod:`repro_torch.lint_rules`; this
slice has the observability rules RPL401-403
(:mod:`repro_torch.lint_rules.obs_rules`), which ``MCMC.run`` also checks
before the first transition and raises with the same code.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from ..lint_rules import ERROR, RULES, WARN
from .errors import ReproValueError


class Finding(NamedTuple):
    """One lint result: a rule code, its severity, the offending site (when
    one can be named), and the full actionable message."""

    code: str
    severity: str
    site: Optional[str]
    message: str

    def __str__(self):
        where = f" (site '{self.site}')" if self.site else ""
        return f"{self.severity.upper():5s} {self.code}{where}: {self.message}"


class LintResult:
    """Findings of one lint pass.  ``result.ok`` is True when no
    *error*-severity finding exists (warnings don't fail)."""

    def __init__(self, findings):
        self.findings = list(findings)

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == WARN]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self):
        return {f.code for f in self.findings}

    def __str__(self):
        if not self.findings:
            return "ok: no findings"
        return "\n".join(str(f) for f in self.findings)

    def __repr__(self):
        return (f"LintResult(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)})")

    def raise_if_errors(self):
        errs = self.errors
        if errs:
            raise ReproValueError(
                f"model failed lint with {len(errs)} error(s):\n"
                + "\n".join(str(f) for f in errs),
                code=errs[0].code, site=errs[0].site)
        return self


__all__ = ["Finding", "LintResult", "RULES"]
