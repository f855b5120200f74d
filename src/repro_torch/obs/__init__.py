"""``repro_torch.obs``: telemetry for the port's chunked MCMC executor.

The executor runs a chain's transitions eagerly from the host, each
reading a few of the sampler's scalars; telemetry must add neither draws
nor reads to that loop.  It follows the samplers' own rule: **metrics are
state**, a ``metrics_fn(state) -> dict`` declared on the
:class:`~repro_torch.core.infer.kernel_api.KernelSetup` that only reads the
state, evaluated beside the collected draws (never fed back into the
transition), and drained to the host once per chunk in one device->host
read.  Sample streams are bit-identical with metrics on or off.

Public surface:

- :class:`~repro_torch.obs.telemetry.Telemetry`: the facade ``MCMC``
  consumes: metrics buffering, phase spans (optionally under
  ``torch.profiler``), counters, event sinks, run manifests.
- :class:`~repro_torch.obs.sinks.JsonlSink` / ``MemorySink``: event
  writers; every event validates against ``event_schema.json``
  (``python -m repro_torch.obs.validate events.jsonl run_manifest.json``).
- :mod:`~repro_torch.obs.manifest`: the per-run manifest (git rev, torch
  and CUDA versions, the card and its power limit, kernel setup hash, chunk
  schedule, final diagnostics) written next to the checkpoints; resumes
  append a session to the same record.
- :class:`~repro_torch.obs.report.LiveReporter`: the chunk-boundary
  progress line.
- :mod:`~repro_torch.obs.monitor`: streaming split R-hat / batch-means ESS
  and the :class:`Converged` stopping rule behind ``MCMC.run(...,
  until=...)`` (convergence-gated runs).
- :mod:`~repro_torch.obs.divergences`: the divergent-transition ring and
  ``python -m repro_torch.obs.divergences <run_dir>``.
- :mod:`~repro_torch.obs.compare`: the cross-run regression gate
  (``python -m repro_torch.obs.compare <current> <baseline>``).

Each module is the JAX package's ``repro.obs`` counterpart, with the same
outputs for the same inputs; the lint rules RPL401-403 that guard the
metrics contract and the stopping rule are in
:mod:`repro_torch.lint_rules.obs_rules`.
"""
from .divergences import DivergenceRing
from .manifest import MANIFEST_NAME, RunManifest, collect_environment
from .metrics import MetricsBuffer, metrics_struct, validate_metrics_struct
from .monitor import Converged, ConvergenceMonitor, StreamingDiagnostics
from .report import LiveReporter
from .sinks import JsonlSink, MemorySink, NullSink
from .spans import SpanRecord
from .telemetry import Telemetry

__all__ = [
    "Converged",
    "ConvergenceMonitor",
    "DivergenceRing",
    "JsonlSink",
    "LiveReporter",
    "MANIFEST_NAME",
    "MemorySink",
    "MetricsBuffer",
    "NullSink",
    "RunManifest",
    "SpanRecord",
    "StreamingDiagnostics",
    "Telemetry",
    "collect_environment",
    "metrics_struct",
    "validate_metrics_struct",
]
