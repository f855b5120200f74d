"""Event sinks: where telemetry events go once they leave the executor.

An *event* is one flat JSON-serializable dict with at least ``kind`` and
``t_unix`` (stamped here, not by callers).  Sinks are deliberately dumb:
the executor drains metrics and spans at chunk boundaries, on the host, so
a sink sees numpy values and Python scalars, never a tensor on the card.
``python -m repro_torch.obs.validate`` checks emitted files against the
schemas in this package.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def _jsonable(v):
    """Coerce numpy scalars and 0-d tensors to plain Python so
    ``json.dump`` works; small arrays and tensors become lists, anything
    else its ``repr``."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        if v.ndim == 0:
            return v.item()
        return v.tolist() if v.numel() <= 4096 else repr(v)
    if isinstance(v, (np.ndarray, np.generic)):
        if v.ndim == 0:
            return v.item()
        return v.tolist() if v.size <= 4096 else repr(v)
    return repr(v)


class NullSink:
    """Discards everything (telemetry disabled, or metrics-only use)."""

    def emit(self, event: dict) -> None:
        pass

    def close(self) -> None:
        pass


class MemorySink:
    """Buffers events in ``self.events``: the test and notebook sink."""

    def __init__(self):
        self.events = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one JSON object per line to ``path``.

    Append-only and line-framed, so a resumed session keeps appending to
    the same file and a half-written trailing line from a kill is
    detectable (it won't parse) without corrupting the rest.
    """

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "a", buffering=1)

    def emit(self, event: dict) -> None:
        self._fh.write(json.dumps(_jsonable(event)) + "\n")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def stamp(kind: str, payload: dict) -> dict:
    """Build one event dict: ``kind``, a wall-clock stamp and the
    payload."""
    event = {"kind": str(kind), "t_unix": time.time()}
    for k, v in payload.items():
        event[k] = _jsonable(v)
    return event
