"""Online convergence monitoring: streaming split R-hat and batch-means ESS.

The post-hoc estimators in :mod:`repro_torch.core.infer.diagnostics` need
the full ``(chains, draws)`` array on the host.  This module computes the
same decisions from sufficient statistics folded at the chunk boundary, so
a run can stop itself the moment its thresholds are met (``MCMC.run(...,
until=Converged(...))``) without touching the sample stream: the fold reads
the chunk's collected draws, never the state that feeds the next
transition, so monitoring on vs. off is bit-identical.

Estimators, both over fixed-size draw batches per chain:

- **split R-hat**: per-(chain, dim) Welford triples ``(count, mean, M2)``
  per batch, merged with Chan's parallel update.  The first half of the
  batches vs. the second half form ``2C`` split chains and the classic
  split-:func:`~repro_torch.core.infer.diagnostics.gelman_rubin` formula
  applies verbatim.
- **batch-means ESS**: ``tau = b * var(batch means) / var(draws)``, pooled
  over chains: ``ESS = C * n / max(tau, 1/(C*n))``.

Accumulator state is a few ``(chains, dims)`` float64 arrays per completed
batch and is JSON-serializable (:meth:`StreamingDiagnostics.state_dict`),
which is how a gated run survives a kill: the executor persists it in the
checkpoint ``extra`` block, and a resumed run re-hydrates it and lands on
the identical stopping iteration (folds depend only on the draw stream, not
on chunk boundaries).  This module is the JAX package's, line for line: the
same draws give the same bits, and each package loads the other's
``state_dict``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


def _combine(na, ma, Ma, nb, mb, Mb):
    """Chan's parallel Welford merge of two (count, mean, M2) triples."""
    if na == 0:
        return nb, mb, Mb
    n = na + nb
    delta = mb - ma
    mean = ma + delta * (nb / n)
    M2 = Ma + Mb + delta * delta * (na * nb / n)
    return n, mean, M2


def _segment_stats(seg):
    """(count, mean, M2) over the draw axis of ``seg``: (C, k, D) -> (C, D)."""
    n = seg.shape[1]
    mean = seg.mean(axis=1)
    M2 = ((seg - mean[:, None, :]) ** 2).sum(axis=1)
    return n, mean, M2


def _reduce(batches, count_each):
    """Merge a list of per-batch (mean, M2) pairs into one triple."""
    n, mean, M2 = 0, None, None
    for bm, bM2 in batches:
        n, mean, M2 = _combine(n, mean, M2, count_each, bm, bM2)
    return n, mean, M2


class Converged(NamedTuple):
    """Stopping rule for a convergence-gated run.

    ``MCMC.run(..., until=Converged(...))`` checks the streaming
    diagnostics between chunks and stops as soon as every
    configured threshold holds (``max_rhat`` over all dims, ``min_ess``
    under all dims), or when ``max_samples`` post-warmup draws have been
    taken — whichever comes first.

    - ``max_samples=None`` caps at the MCMC's own ``num_samples``; a larger
      value lets a gated run draw past it when convergence is slow.
    - ``check_every`` sets the chunk length (and therefore the gate
      cadence) when no ``checkpoint_every`` is given; an explicit
      ``checkpoint_every`` wins, keeping chunk boundaries — and therefore
      resume behaviour — a pure function of the run geometry.
    - ``batch_size`` is the streaming accumulator's draw-batch length:
      diagnostics only see completed batches, so thresholds are evaluated
      on draws up to the last full batch (a lag of at most ``batch_size -
      1`` draws), and batch-means ESS needs ``batch_size`` well above the
      chain's autocorrelation time to be calibrated.

    Geometry that can never stop (``min_ess`` above the total draw budget,
    a ``max_rhat`` below 1, fewer than four batches ever completing) is
    **RPL403**, rejected eagerly by ``MCMC.run`` before the first transition.
    """
    max_rhat: Optional[float] = 1.01
    min_ess: Optional[float] = None
    max_samples: Optional[int] = None
    check_every: int = 100
    batch_size: int = 20

    def satisfied(self, max_rhat_val, min_ess_val) -> bool:
        """True iff every configured threshold holds (NaN — diagnostics
        not yet estimable — never satisfies)."""
        if self.max_rhat is not None:
            if not np.isfinite(max_rhat_val) or max_rhat_val > self.max_rhat:
                return False
        if self.min_ess is not None:
            if not np.isfinite(min_ess_val) or min_ess_val < self.min_ess:
                return False
        return True


class StreamingDiagnostics:
    """Streaming split R-hat / batch-means ESS accumulator.

    Fold ``(chains, draws, dims)`` chunks as they drain; query
    :meth:`split_rhat` / :meth:`ess` at any point.  State is a function of
    the draw *stream* only — chunk boundaries do not matter — which is what
    makes checkpoint/resume land on identical decisions.
    """

    def __init__(self, batch_size: int = 20):
        if int(batch_size) < 2:
            raise ValueError("batch_size must be at least 2")
        self.batch_size = int(batch_size)
        self.num_draws = 0
        self._shape = None      # (chains, dims), fixed at first fold
        self._batches = []      # [(mean (C,D), M2 (C,D))] — full batches
        self._pending = None    # (C, r, D) raw draws of the trailing batch

    # -- folding ------------------------------------------------------------
    def fold(self, z) -> None:
        """Fold one drained chunk of draws: ``z`` is ``(chains, k)`` or
        ``(chains, k, ...)``; trailing axes are flattened to dims.

        The trailing partial batch is buffered as *raw draws* (at most
        ``batch_size - 1`` of them), so every completed batch's statistics
        are computed from exactly its own ``batch_size`` draws in one pass —
        the accumulator state is bitwise independent of how the stream was
        chunked, which is what lets a resumed run (different chunk
        boundaries up to the kill) reach identical gate decisions."""
        z = np.asarray(z, np.float64)
        if z.ndim < 2:
            raise ValueError(f"fold expects (chains, draws, ...), got "
                             f"shape {z.shape}")
        z = z.reshape(z.shape[0], z.shape[1], -1)
        if self._shape is None:
            self._shape = (z.shape[0], z.shape[2])
        elif (z.shape[0], z.shape[2]) != self._shape:
            raise ValueError(
                f"fold shape {(z.shape[0], z.shape[2])} does not match "
                f"accumulator shape {self._shape}")
        self.num_draws += z.shape[1]
        data = z if self._pending is None else np.concatenate(
            [self._pending, z], axis=1)
        b = self.batch_size
        nfull = data.shape[1] // b
        for j in range(nfull):
            _, mean, M2 = _segment_stats(data[:, j * b:(j + 1) * b])
            self._batches.append((mean, M2))
        rest = data[:, nfull * b:]
        self._pending = rest.copy() if rest.shape[1] else None

    # -- estimates ----------------------------------------------------------
    @property
    def num_batches(self) -> int:
        return len(self._batches)

    def _nan(self):
        d = self._shape[1] if self._shape is not None else 1
        return np.full(d, np.nan)

    def split_rhat(self):
        """Per-dim split R-hat over the completed batches: first half of
        the batches vs. second half per chain -> 2C split chains, then the
        verbatim :func:`~repro_torch.core.infer.diagnostics.gelman_rubin`
        formula.  With an odd batch count the middle batch is dropped so
        the halves stay equal length.  NaN until two batches per half
        exist."""
        K = len(self._batches)
        h = K // 2
        if h < 1 or self._shape is None:
            return self._nan()
        b = self.batch_size
        n1, m1, S1 = _reduce(self._batches[:h], b)
        n2_, m2, S2 = _reduce(self._batches[K - h:], b)
        means = np.concatenate([m1, m2], axis=0)        # (2C, D)
        M2s = np.concatenate([S1, S2], axis=0)
        n2 = h * b                                       # draws per split
        chain_var = M2s / (n2 - 1)
        W = chain_var.mean(axis=0)
        B = n2 * means.var(axis=0, ddof=1)
        var_plus = (n2 - 1) / n2 * W + B / n2
        return np.sqrt(var_plus / np.where(W == 0, 1.0, W))

    def ess(self):
        """Per-dim batch-means ESS over the completed batches, pooled over
        chains (floor matches the post-hoc Geyer estimator's).  NaN until
        two batches exist.  This is a *within-chain* mixing estimate —
        batch means deviate about their own chain's mean — so chains stuck
        in different modes are R-hat's job, not ESS's (same division of
        labour as the post-hoc pair)."""
        K = len(self._batches)
        if K < 2 or self._shape is None:
            return self._nan()
        C = self._shape[0]
        b = self.batch_size
        n = K * b
        means = np.stack([m for m, _ in self._batches], axis=1)  # (C, K, D)
        _, _, M2_tot = _reduce(self._batches, b)
        s2 = (M2_tot / (n - 1)).mean(axis=0)             # pooled draw var
        bm_var = means.var(axis=1, ddof=1).mean(axis=0)  # pooled batch-mean var
        tau = b * bm_var / np.where(s2 == 0, 1.0, s2)
        tau = np.where(s2 == 0, np.inf, tau)             # constant dim: no info
        return C * n / np.maximum(tau, 1.0 / (C * n))

    # -- checkpoint serialization -------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable state (the checkpoint ``extra`` payload)."""
        return {
            "batch_size": self.batch_size,
            "num_draws": self.num_draws,
            "shape": list(self._shape) if self._shape is not None else None,
            "batches": [[m.tolist(), M2.tolist()]
                        for m, M2 in self._batches],
            "pending": (self._pending.tolist()
                        if self._pending is not None else None),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "StreamingDiagnostics":
        self = cls(batch_size=state["batch_size"])
        self.num_draws = int(state["num_draws"])
        shape = state.get("shape")
        self._shape = tuple(shape) if shape is not None else None
        self._batches = [(np.asarray(m, np.float64),
                          np.asarray(M2, np.float64))
                         for m, M2 in state["batches"]]
        p = state.get("pending")
        self._pending = np.asarray(p, np.float64) if p is not None else None
        return self


class ConvergenceMonitor:
    """The executor-facing glue: fold the chunk's drained positions, check
    the :class:`Converged` thresholds, keep a decision history, and
    round-trip through the checkpoint ``extra`` block."""

    def __init__(self, until: Converged):
        self.until = until
        self.diag = StreamingDiagnostics(batch_size=until.batch_size)
        self.history = []        # one record per gate check
        self.decision = None     # set once, at the stopping check

    def fold(self, z) -> None:
        self.diag.fold(z)

    def check(self, draws_done: int) -> bool:
        """Gate check after a drained sample chunk (``draws_done`` =
        post-warmup draws folded so far).  Records the history entry and,
        on the first satisfied check, the stopping decision."""
        rhat = self.diag.split_rhat()
        ess = self.diag.ess()
        max_rhat = float(np.nanmax(rhat)) if np.isfinite(rhat).any() \
            else float("nan")
        min_ess = float(np.nanmin(ess)) if np.isfinite(ess).any() \
            else float("nan")
        stop = self.until.satisfied(max_rhat, min_ess)
        self.history.append({"draws": int(draws_done),
                             "max_rhat": max_rhat, "min_ess": min_ess,
                             "converged": bool(stop)})
        if stop and self.decision is None:
            self.decision = {
                "stopped_at_draws": int(draws_done),
                "reason": "converged",
                "max_rhat": max_rhat,
                "min_ess": min_ess,
                "thresholds": {"max_rhat": self.until.max_rhat,
                               "min_ess": self.until.min_ess,
                               "max_samples": self.until.max_samples},
            }
        return stop

    def exhausted(self, draws_done: int) -> None:
        """Record the budget-exhausted decision (cap reached unconverged)."""
        if self.decision is None:
            last = self.history[-1] if self.history else {}
            self.decision = {
                "stopped_at_draws": int(draws_done),
                "reason": "max_samples",
                "max_rhat": last.get("max_rhat", float("nan")),
                "min_ess": last.get("min_ess", float("nan")),
                "thresholds": {"max_rhat": self.until.max_rhat,
                               "min_ess": self.until.min_ess,
                               "max_samples": self.until.max_samples},
            }

    # -- checkpoint round-trip ----------------------------------------------
    def state_dict(self) -> dict:
        """Accumulators, history, *and* the stopping decision: a kill that
        lands after the decisive chunk's state write must not let the
        resumed run draw past the stopping iteration the original run
        chose — the executor checks ``decision`` before advancing."""
        return {"diag": self.diag.state_dict(), "history": self.history,
                "decision": self.decision}

    def load_state_dict(self, state: dict) -> None:
        self.diag = StreamingDiagnostics.from_state_dict(state["diag"])
        self.history = list(state["history"])
        self.decision = state.get("decision")


__all__ = ["Converged", "ConvergenceMonitor", "StreamingDiagnostics"]
