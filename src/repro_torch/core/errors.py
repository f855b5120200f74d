"""Shared error hierarchy with stable rule codes.

The same ``RPL###`` vocabulary as the JAX package: a defect the runtime
reports carries the code the static analyzer would report for it.  The
classes multiply-inherit from the builtin exception the call sites would
otherwise raise, so ``except ValueError`` keeps working; new code should
catch :class:`ReproError` and dispatch on ``.code``.

Two codes are particular to this package:

- ``RPL501`` (:data:`PENDING`): the feature exists in the JAX package but
  has not been ported yet; the message names the work it waits for.
- ``RPL502`` (:data:`NO_DEVICE`): an entry point was asked to run on a
  device this process does not have.
- ``RPL503`` (:data:`KERNEL_MISMATCH`): a fused potential built on a
  hand-written kernel disagreed with the model's plain potential.
"""
from __future__ import annotations

from typing import Optional

PENDING = "RPL501"
NO_DEVICE = "RPL502"
KERNEL_MISMATCH = "RPL503"


class ReproError(Exception):
    """Base class for coded model/handler/inference errors.

    ``code`` is a stable rule identifier (``"RPL007"``-style); ``site``
    optionally names the offending sample/param/plate site.  The code is
    prepended to the message (``[RPL007] ...``) unless already present.
    """

    code: Optional[str] = None

    def __init__(self, message: str = "", *, code: Optional[str] = None,
                 site: Optional[str] = None):
        if code is not None:
            self.code = code
        self.site = site
        if self.code and not str(message).startswith(f"[{self.code}]"):
            message = f"[{self.code}] {message}"
        super().__init__(message)


class ReproValueError(ReproError, ValueError):
    """Coded error for call sites that would raise ValueError."""


class ReproRuntimeError(ReproError, RuntimeError):
    """Coded error for call sites that would raise RuntimeError."""


class ReproNotImplementedError(ReproError, NotImplementedError):
    """Coded error for structural limitations (not bugs)."""


class ReproWarning(UserWarning):
    """Coded warning: the rule code is embedded in the message text."""


def warning_code(warning_message: str) -> Optional[str]:
    """Extract a leading ``[RPL###]`` code from a warning message."""
    text = str(warning_message)
    if text.startswith("[") and "]" in text:
        code = text[1:text.index("]")]
        if code.startswith("RPL"):
            return code
    return None


def pending(feature: str, slice_name: str) -> ReproNotImplementedError:
    """The coded error for a feature that waits for a later port slice."""
    return ReproNotImplementedError(
        f"{feature} is not ported to repro_torch yet; it waits for the "
        f"{slice_name} slice (see ROADMAP.md). The JAX package `repro` "
        "has it.", code=PENDING)


__all__ = [
    "KERNEL_MISMATCH",
    "NO_DEVICE",
    "PENDING",
    "ReproError",
    "ReproValueError",
    "ReproRuntimeError",
    "ReproNotImplementedError",
    "ReproWarning",
    "pending",
    "warning_code",
]
