"""Chunk-boundary live reporter.

One line per completed chunk, built entirely from values the executor
already has on the host (the chunk's drained metrics or collected fields):
per-chunk divergence delta, current step size, chunk-mean accept
probability, the latest gate check's R-hat/ESS and an ETA from the latest
chunk's iteration rate.  The line keeps the stable machine-readable prefix
log scrapers rely on::

    [MCMC] {done}/{total} iterations ({phase}) | chains: {C} | divergences: {D}

with the richer fields appended after it, character for character the JAX
package's line for the same inputs.  It only ever sees host numpy trees.
"""
from __future__ import annotations

import time

import numpy as np


def _fmt_eta(seconds: float) -> str:
    seconds = max(0.0, float(seconds))
    if seconds < 100:
        return f"{seconds:.0f}s"
    minutes, secs = divmod(int(round(seconds)), 60)
    if minutes < 100:
        return f"{minutes}m{secs:02d}s"
    hours, minutes = divmod(minutes, 60)
    return f"{hours}h{minutes:02d}m"


class LiveReporter:
    """Stateful per-run reporter; ``start()`` resets it, ``chunk()`` formats
    (and optionally prints) one chunk-boundary line."""

    def __init__(self, print_fn=None):
        self._print = print_fn if print_fn is not None else (
            lambda line: print(line, flush=True))
        self.start(0)

    def start(self, total: int) -> None:
        self.total = int(total)
        self.lines = []
        self._last_t = time.monotonic()
        self._last_done = None  # first chunk of a (possibly resumed) run

    def chunk(self, *, done: int, total: int, phase: str, num_chains: int,
              divergences: int, delta_div=None, metrics=None,
              convergence=None, emit: bool = True) -> str:
        now = time.monotonic()
        line = (f"[MCMC] {done}/{total} iterations ({phase}) | "
                f"chains: {num_chains} | divergences: {divergences}")
        if delta_div:
            line += f" | +{int(delta_div)} div"
        line += self._metrics_fields(metrics)
        line += self._convergence_fields(convergence)
        # ETA from the most recent chunk's rate: the first chunk of a run
        # carries one-time work, so a fresher rate beats a run mean
        if self._last_done is not None and done > self._last_done:
            rate = (done - self._last_done) / max(now - self._last_t, 1e-9)
            if done < total and rate > 0:
                line += f" | eta: {_fmt_eta((total - done) / rate)}"
        self._last_t, self._last_done = now, done
        self.lines.append(line)
        if emit:
            self._print(line)
        return line

    @staticmethod
    def _metrics_fields(metrics) -> str:
        """``step``/``accept`` summary from a host metrics (or collect)
        tree: step size from the chunk's final draw, accept probability
        as the chunk mean — both averaged over chains when per-chain."""
        if not metrics:
            return ""
        out = ""
        step = metrics.get("step_size")
        if step is not None:
            out += f" | step: {float(np.asarray(step)[..., -1].mean()):.3g}"
        accept = metrics.get("accept_prob")
        if accept is not None:
            out += f" | accept: {float(np.asarray(accept).mean()):.2f}"
        return out

    @staticmethod
    def _convergence_fields(conv) -> str:
        """Streaming-diagnostics summary from a gated run's latest gate
        check (a ``ConvergenceMonitor.history`` entry); NaN values — not
        yet estimable — are simply omitted."""
        if not conv:
            return ""
        out = ""
        rhat, ess = conv.get("max_rhat"), conv.get("min_ess")
        if rhat is not None and np.isfinite(rhat):
            out += f" | rhat: {rhat:.3f}"
        if ess is not None and np.isfinite(ess):
            out += f" | ess: {ess:.0f}"
        return out
