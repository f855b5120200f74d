"""``Telemetry``: the one object ``MCMC`` consumes.

Bundles the telemetry concerns so the executor stays small: the metrics
stream buffer (chunk-boundary drains of ``metrics_fn`` outputs), phase
spans (optionally attached to ``torch.profiler``), event sinks (JSONL), the
per-run manifest and the divergence forensics ring.  Construction is cheap
and declarative; all I/O is lazy until :meth:`begin_run` resolves where
artifacts go (``dir=...`` here, else next to the run's ``checkpoint_dir``,
else memory only).

Example::

    from repro_torch import obs
    tele = obs.Telemetry(dir="runs/exp1")      # events.jsonl + manifest
    mcmc = MCMC(kernel, 500, 1000, num_chains=4, telemetry=tele)
    mcmc.run(0, data)
    tele.buffer.series()["accept_prob"]         # (chains, draws)
    [s.name for s in tele.spans]                # phase timings

The invariants the executor holds this object to:

- enabling it never changes the sample stream (metrics only read the
  state, beside the collected draws; bit-identity is tested);
- it adds at most one device->host read a chunk (the drain, which the
  divergence mask and the chunk span's close ride), counted in
  ``MCMC.stats["host_syncs"]``, plus one for a chunk that diverged when
  forensics is on;
- it never calls ``repro_torch.distributed.checkpoint.save`` (the kill
  points of the kill tests stay fixed).

``counters`` counts ``kernel_builds`` (kernel libraries loaded at first
use) and ``graph_captures`` (ChEES's CUDA graphs) during the chunks, the
one-time device work that makes a chunk span ``program_cold``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

from .divergences import DivergenceRing
from .manifest import MANIFEST_NAME, RunManifest
from .metrics import MetricsBuffer
from .report import LiveReporter
from .sinks import JsonlSink, MemorySink, NullSink, stamp
from .spans import SpanClock

_CHUNK_SPANS = ("warmup_chunk", "sample_chunk")


class Telemetry:
    def __init__(self, *, metrics: bool = True, dir: Optional[str] = None,
                 sink=None, events: bool = True, manifest: bool = True,
                 reporter: Optional[LiveReporter] = None,
                 profile_dir: Optional[str] = None,
                 profile_spans=_CHUNK_SPANS, forensics: bool = True,
                 forensics_capacity: int = 256):
        self.metrics = bool(metrics)
        self.dir = str(dir) if dir is not None else None
        self._sink_arg = sink
        self._events = bool(events)
        self._manifest_enabled = bool(manifest)
        self.reporter = reporter if reporter is not None else LiveReporter()
        self.profile_dir = (str(profile_dir) if profile_dir is not None
                            else None)
        self.profile_spans = tuple(profile_spans)
        # divergence forensics: a bounded ring of divergent-transition
        # records the executor feeds at the chunk drain, written to
        # divergences.json at finish_run for `python -m
        # repro_torch.obs.divergences <run_dir>`
        self._forensics_enabled = bool(forensics)
        self._forensics_capacity = int(forensics_capacity)
        self.forensics: Optional[DivergenceRing] = None
        self.buffer = MetricsBuffer()
        self.sink = sink if sink is not None else NullSink()
        self.manifest: Optional[RunManifest] = None
        self.spans = []
        self.counters = {}
        self._artifact_dir = None
        self._profiling = False
        self._span_seq = 0

    # -- run lifecycle ------------------------------------------------------
    def begin_run(self, run_config: dict, *, default_dir=None,
                  resume: bool = False) -> None:
        """Reset per-run state and open artifacts.  Artifacts land in
        ``self.dir`` when set, else in ``default_dir`` (the run's
        checkpoint_dir), else stay in memory (``MemorySink``).

        ``run_config`` may be provisional (the executor calls this before
        building the kernel setup, so early spans have a live sink);
        :meth:`commit_run_config` fills in the setup-derived fields and
        emits the ``run_started`` event."""
        base = self.dir if self.dir is not None else default_dir
        self._artifact_dir = base
        self.buffer.clear()
        self.spans = []
        self.counters = {}
        self._span_seq = 0
        self.forensics = (DivergenceRing(self._forensics_capacity)
                          if self._forensics_enabled else None)
        self._run_config = dict(run_config)
        self._resume = bool(resume)
        if self._sink_arg is not None:
            self.sink = self._sink_arg
        elif not self._events:
            self.sink = NullSink()
        elif base is not None:
            self.sink = JsonlSink(os.path.join(base, "events.jsonl"))
        else:
            self.sink = MemorySink()
        if self._manifest_enabled and base is not None:
            self.manifest = RunManifest(os.path.join(base, MANIFEST_NAME))
            self.manifest.begin_session(run_config=self._run_config,
                                        resume=resume)
        else:
            self.manifest = None

    def commit_run_config(self, **updates) -> None:
        """Finalize the run record once the kernel setup exists (algo,
        setup hash) and announce the run on the event stream."""
        self._run_config.update(updates)
        if self.manifest is not None:
            self.manifest.data["run"].update(updates)
            self.manifest.flush()
        self.event("run_started", resume=self._resume, **self._run_config)

    def set_resumed_at(self, done: int) -> None:
        """Record the iteration a resumed session restarted from (known
        only after the checkpoint restore)."""
        if self.manifest is not None:
            self.manifest.session()["resumed_at_iteration"] = int(done)
            self.manifest.flush()

    def finish_run(self, final: dict) -> None:
        self.event("run_finished", **final)
        if self.manifest is not None:
            self.manifest.finish_session(counters=dict(self.counters),
                                         final=final)
        if self.forensics is not None and self._artifact_dir is not None:
            # plain atomic JSON like the manifest, never checkpoint.save
            self.forensics.write(self._artifact_dir)
        self.sink.close()

    # -- events / counters --------------------------------------------------
    def event(self, kind: str, **payload) -> None:
        self.sink.emit(stamp(kind, payload))

    def counter(self, name: str, inc: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(inc)

    # -- spans --------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time one host-side phase.  Yields a mutable attr dict the body
        may extend (the executor marks a chunk ``program_cold`` once it
        knows).  With ``profile_dir`` set and ``name`` in
        ``profile_spans``, the span runs under ``torch.profiler.profile``
        (the CPU, and the card when there is one; never nested) and exports
        one Chrome trace, ``<profile_dir>/<seq>_<name>/trace.json``."""
        clock = SpanClock(name, attrs)
        profiling = (self.profile_dir is not None
                     and name in self.profile_spans and not self._profiling)
        trace_dir = None
        if profiling:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self._span_seq += 1
            trace_dir = os.path.join(self.profile_dir,
                                     f"{self._span_seq:04d}_{name}")
            self._profiling = True
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            ctx = profile(activities=activities)
        else:
            ctx = contextlib.nullcontext()
        try:
            with ctx as prof:
                yield clock.attrs
            if profiling:
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir,
                                                      "trace.json"))
        finally:
            if profiling:
                self._profiling = False
            record = clock.close()
            self.spans.append(record)
            self.sink.emit(stamp("span", record.to_event()))
            if self.manifest is not None:
                self.manifest.record_span(record)

    # -- chunk boundary -----------------------------------------------------
    def drain_chunk(self, phase: str, start: int, end: int, metrics_tree):
        """Buffer one chunk's metrics (device leaves copied in one read; the
        executor hands over the host tree its own drain made) and emit the
        chunk event.  Returns the host tree (for the live reporter) or
        None."""
        host = None
        if metrics_tree is not None:
            host = self.buffer.add_chunk(phase, start, end, metrics_tree)
        if self.manifest is not None:
            self.manifest.record_chunk(start, end, phase)
        payload = {"phase": phase, "start": start, "end": end}
        if host is not None:
            payload["metrics"] = {
                k: {"mean": float(v.mean()),
                    "last": float(v[..., -1].mean())}
                for k, v in host.items()}
        self.event("chunk", **payload)
        return host

    def record_divergences(self, total: int) -> None:
        if self.manifest is not None:
            self.manifest.set_divergences(total)
