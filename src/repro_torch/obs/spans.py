"""Phase spans: wall-clock timing of the executor's host-side phases.

A span brackets one phase of an ``MCMC.run``: setup (moving the arguments,
tracing the model), init or resume-restore, each warmup/sample chunk, each
checkpoint write.  A chunk span closes on finished device work: the chunk's
one metrics drain (a device->host read) happens inside it, or, when there
is nothing to drain, one counted synchronize.  ``program_cold`` marks the
chunk spans in which one-time device work ran (a kernel library loaded at
first use, a CUDA graph captured), so a cold span's time is not read as a
steady-state one.

Optionally a span attaches ``torch.profiler`` (see
:meth:`repro_torch.obs.telemetry.Telemetry.span`).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional


class SpanRecord(NamedTuple):
    """One closed span: name, wall-clock seconds, and static attributes
    (chunk range, phase, cold/warm program, checkpoint step, ...)."""

    name: str
    start_unix: float
    duration_s: float
    attrs: tuple  # sorted (key, value) pairs: hashable, JSON-friendly

    def attr(self, key, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    def to_event(self) -> dict:
        event = {"span": self.name, "start_unix": self.start_unix,
                 "duration_s": self.duration_s}
        event.update(dict(self.attrs))
        return event


class SpanClock:
    """Open span being timed; closed by the ``Telemetry.span`` context
    manager into a :class:`SpanRecord`."""

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = dict(attrs)
        self.start_unix = time.time()
        self._t0 = time.monotonic()

    def close(self, extra_attrs: Optional[dict] = None) -> SpanRecord:
        if extra_attrs:
            self.attrs.update(extra_attrs)
        return SpanRecord(
            name=self.name, start_unix=self.start_unix,
            duration_s=time.monotonic() - self._t0,
            attrs=tuple(sorted(self.attrs.items())))
