"""Core language primitives: ``sample``, ``param``, ``deterministic``,
``subsample`` and ``plate``.

Each primitive builds a *message* (a plain dict) and threads it through the
handler stack (see :mod:`repro_torch.core.handlers`).  Handlers run in the
Python interpreter around eager PyTorch code, so a model is an ordinary
Python function of tensors.

Message anatomy (the contract every handler programs against)::

    {
      "type":   "sample" | "param" | "deterministic" | "plate" |
              "subsample",
      "name":   str,
      "fn":     callable,             # produces "value" when it is None
      "args", "kwargs":               # forwarded to fn; kwargs carries the
                                      # torch.Generator for random sites
      "value":  None | tensor,
      "is_observed": bool,            # True => value is data, not a draw
      "scale":  None | float | tensor,
      "mask":   None | bool tensor,
      "cond_indep_stack": [CondIndepStackFrame, ...],
      "infer":  dict,
      "stop":   bool (optional),      # set by `block`
    }

``scale`` and ``mask`` are accumulated by handlers and consumed once, by
:func:`repro_torch.core.infer.util.log_density`, as
``sum(where(mask, log_prob, 0) * scale)``.
"""
from __future__ import annotations

import warnings
from collections import namedtuple
from functools import partial
from typing import Optional

import torch

from .errors import ReproValueError, ReproWarning

_STACK: list = []  # the global effect-handler stack

# Monotone counter of handler episodes: bumped every time the stack drains
# back to empty (one model execution under its handlers = one episode).
# plate uses it to scope its subsample-index cache.
_EPISODE = 0


def stack() -> list:
    return _STACK


CondIndepStackFrame = namedtuple("CondIndepStackFrame", ["name", "dim", "size"])


def _shape(value) -> tuple:
    return tuple(value.shape) if hasattr(value, "shape") else ()


def default_process_message(msg: dict) -> None:
    """Produce the message value if no handler already did."""
    if msg["value"] is None:
        if msg["type"] == "sample":
            if msg["kwargs"]["generator"] is None and not msg["is_observed"]:
                raise ReproValueError(
                    f"latent sample site '{msg['name']}' reached evaluation "
                    "without a generator: no enclosing `seed` handler "
                    "supplied one and no handler substituted a value. Wrap "
                    "the model in seed(model, rng_seed), or pin the site "
                    "with substitute/condition.", code="RPL009",
                    site=msg["name"])
            msg["value"] = msg["fn"](
                generator=msg["kwargs"]["generator"],
                sample_shape=msg["kwargs"]["sample_shape"],
            )
        else:
            msg["value"] = msg["fn"](*msg["args"], **msg["kwargs"])


def pop_from_stack(handler) -> None:
    """Remove ``handler`` from the stack, unwinding robustly: if an exception
    skipped inner ``__exit__`` calls, everything above ``handler`` is popped
    too.  Draining the stack ends the current handler episode."""
    global _EPISODE
    if _STACK and _STACK[-1] is handler:
        _STACK.pop()
    elif handler in _STACK:
        while _STACK and _STACK[-1] is not handler:
            _STACK.pop()
        if _STACK:
            _STACK.pop()
    if not _STACK:
        _EPISODE += 1


def apply_stack(msg: dict) -> dict:
    """Thread ``msg`` through the handler stack.

    ``process_message`` runs from innermost (top of stack) to outermost; a
    handler may set ``msg['stop'] = True`` to hide the site from outer
    handlers.  ``postprocess_message`` then runs from the point we stopped
    back down to the innermost handler.
    """
    pointer = 0
    for pointer, handler in enumerate(reversed(_STACK)):
        handler.process_message(msg)
        if msg.get("stop"):
            break
    default_process_message(msg)
    for handler in _STACK[-pointer - 1:]:
        handler.postprocess_message(msg)
    return msg


def sample(name: str, fn, obs=None, generator: Optional[torch.Generator] = None,
           sample_shape: tuple = (), infer: Optional[dict] = None):
    """Draw a (named) random sample from distribution ``fn``.

    With ``obs`` the site is observed and contributes ``fn.log_prob(obs)``
    to the joint density.  Without an enclosing
    :class:`~repro_torch.core.handlers.seed` handler an explicit
    ``generator`` must be supplied.
    """
    if not _STACK:
        if obs is not None:
            return obs
        if generator is None:
            raise ReproValueError(
                f"sample site '{name}' outside any handler requires an "
                "explicit generator (see the `seed` handler).",
                code="RPL009", site=name)
        return fn(generator=generator, sample_shape=sample_shape)

    msg = {
        "type": "sample",
        "name": name,
        "fn": fn,
        "args": (),
        "kwargs": {"generator": generator, "sample_shape": sample_shape},
        "value": obs,
        "is_observed": obs is not None,
        "scale": None,
        "mask": None,
        "cond_indep_stack": [],
        "infer": dict(infer) if infer else {},
    }
    apply_stack(msg)
    _check_observed_support(msg)
    return msg["value"]


def _check_observed_support(msg: dict) -> None:
    """Runtime twin of lint rule RPL005: an observed value outside the
    distribution's support scores ``-inf``/``nan`` silently — diagnose it
    at the site instead.  Masked sites are exempt, and so are sites a
    handler marked ``support_checked`` (the sampler's potential, which
    re-runs a model whose data was checked once at setup: the check reads
    the value back to the host, which on a device is a sync per call), and
    so are values on the ``meta`` device, which have none."""
    if not msg["is_observed"] or msg["mask"] is not None \
            or msg.get("support_checked"):
        return
    if isinstance(msg["value"], torch.Tensor) and msg["value"].is_meta:
        return  # an abstract value (lint's meta pass): nothing to judge
    try:
        support = msg["fn"].support
    except NotImplementedError:
        return
    if support is None:
        return
    try:
        ok = support(msg["value"])
    except NotImplementedError:
        return
    if not bool(torch.all(torch.as_tensor(ok))):
        raise ReproValueError(
            f"observed value at sample site '{msg['name']}' lies outside the "
            f"distribution's support ({support!r}); its log probability is "
            "-inf/nan. Fix the data, choose a distribution whose support "
            "covers it, or mask the offending elements.",
            code="RPL005", site=msg["name"])


def param(name: str, init_value=None, *, shape=None, init_fn=None,
          dtype=torch.float32, **kwargs):
    """Declare a learnable parameter.

    Either pass a concrete ``init_value``, or ``shape`` (+ optional
    ``init_fn`` taking ``(generator, shape, dtype)``) for lazy
    initialization under a ``seed`` handler.  Param sites are not scored by
    ``log_density``.
    """
    if not _STACK:
        return init_value

    def identity(*args, **kw):
        return init_value

    msg = {
        "type": "param",
        "name": name,
        "fn": identity,
        "args": (),
        "kwargs": dict(kwargs, shape=shape, init_fn=init_fn, dtype=dtype),
        "value": None,
        "is_observed": False,
        "scale": None,
        "mask": None,
        "cond_indep_stack": [],
        "infer": {},
    }
    result = apply_stack(msg)["value"]
    if result is None:
        raise ValueError(
            f"param site '{name}' has no value: provide init_value, or run "
            "under a `substitute`/`seed` handler that materializes "
            "parameters.")
    return result


def deterministic(name: str, value):
    """Record a deterministic value in the trace.  Deterministic sites never
    contribute to the joint density."""
    if not _STACK:
        return value
    msg = {
        "type": "deterministic",
        "name": name,
        "fn": lambda: value,
        "args": (),
        "kwargs": {},
        "value": value,
        "is_observed": False,
        "scale": None,
        "mask": None,
        "cond_indep_stack": [],
        "infer": {},
    }
    return apply_stack(msg)["value"]


def _subsample_indices(size, subsample_size, generator=None):
    """Minibatch index vector for a plate: the first ``subsample_size``
    entries of a random permutation of ``range(size)``, or ``arange`` when
    there is no subsampling or no generator."""
    if subsample_size >= size:
        return torch.arange(size)
    if generator is None:
        warnings.warn(ReproWarning(
            f"[RPL012] subsampled plate (size={size}, "
            f"subsample_size={subsample_size}) run without a generator: "
            "falling back to deterministic arange indices. Wrap the model in "
            "a `seed` handler for random-minibatch subsampling."),
            stacklevel=2)
        return torch.arange(subsample_size)
    return torch.randperm(size, generator=generator)[:subsample_size]


def subsample(data, event_dim: int = 0):
    """Select the enclosing plates' minibatch rows of ``data``.

    For each active :class:`plate` whose dimension (counted from the right
    of the batch shape, i.e. offset left by ``event_dim``) has the plate's
    full ``size`` in ``data``, the plate's current subsample indices are
    taken along that dimension with ``torch.index_select``.  Data already
    of minibatch size passes through unchanged, so the same model code
    runs full-batch and subsampled.  Outside any handler, or outside any
    plate, ``data`` is returned as it is.
    """
    if not _STACK:
        return data
    msg = {
        "type": "subsample",
        "name": None,
        "fn": lambda *a, **kw: data,
        "args": (),
        "kwargs": {"event_dim": event_dim},
        "value": data,
        "is_observed": False,
        "scale": None,
        "mask": None,
        "cond_indep_stack": [],
        "infer": {},
    }
    return apply_stack(msg)["value"]


class plate:
    """Conditional-independence context manager.

    Samples drawn inside are batched along ``dim`` (negative, counted from
    the right of the batch shape).  With ``subsample_size < size`` the plate
    draws a random minibatch of indices (returned by ``__enter__``) and
    rescales the log density of every enclosed site by
    ``size / subsample_size``.

    Handler-protocol effects (in ``process_message``) on ``sample`` sites:
    append a :class:`CondIndepStackFrame`, expand the distribution's batch
    shape along ``dim`` (its extent there must be 1 or ``subsample_size``),
    check the batch extent of an observed value, and accumulate the
    ``size / subsample_size`` density scale.  On ``subsample`` messages:
    take the plate's minibatch indices along the matching data dim.

    The index draw is a ``"plate"`` message, so ``seed`` supplies the
    generator, ``trace`` records the indices and ``substitute`` can pin
    them.  Indices are cached on the plate for one handler episode.
    """

    def __init__(self, name: str, size: int,
                 subsample_size: Optional[int] = None,
                 dim: Optional[int] = None):
        if size <= 0:
            raise ValueError(f"plate '{name}' needs positive size, got {size}")
        if subsample_size is not None and not 0 < subsample_size <= size:
            raise ValueError(
                f"plate '{name}' subsample_size must be in (0, {size}], got "
                f"{subsample_size}")
        self.name = name
        self.size = size
        self.subsample_size = size if subsample_size is None else subsample_size
        if dim is not None and dim >= 0:
            raise ValueError("plate dim must be negative (counted from the right)")
        self.dim = dim
        self._indices = None
        self._cache_token = None
        self._site_name = name    # post-stack name (scope may prefix it)
        self._frame = None

    def _get_indices(self):
        if self._indices is not None and self._cache_token != _EPISODE:
            self._indices = None  # a new model execution: redraw
            self._site_name = self.name
        if self._indices is None:
            self._cache_token = _EPISODE
            if self.subsample_size < self.size and _STACK:
                msg = {
                    "type": "plate",
                    "name": self.name,
                    "fn": partial(_subsample_indices, self.size,
                                  self.subsample_size),
                    "args": (),
                    "kwargs": {"generator": None},
                    "value": None,
                    "is_observed": False,
                    "scale": None,
                    "mask": None,
                    "cond_indep_stack": [],
                    "infer": {},
                }
                out = apply_stack(msg)
                indices = out["value"]
                # handlers may rewrite the site name (scope); frames carry
                # the name the trace records, so that consumers matching
                # frames to recorded plate sites (AutoNormal) find them
                self._site_name = out["name"]
                if _shape(indices) != (self.subsample_size,):
                    raise ValueError(
                        f"plate '{self.name}': injected subsample indices "
                        f"have shape {_shape(indices)}, expected "
                        f"({self.subsample_size},)")
                if indices.numel() and (int(indices.min()) < 0
                                        or int(indices.max()) >= self.size):
                    raise ValueError(
                        f"plate '{self.name}': injected subsample indices "
                        f"fall outside [0, {self.size})")
                self._indices = indices
            else:
                self._indices = _subsample_indices(self.size,
                                                   self.subsample_size)
        return self._indices

    @staticmethod
    def _occupied_dims():
        return {h._frame.dim for h in _STACK
                if isinstance(h, plate) and h._frame is not None}

    def __enter__(self):
        if any(h is self for h in _STACK):
            raise ValueError(
                f"plate '{self.name}' is already active and cannot be "
                "re-entered while open (construct a second plate instead)")
        occupied = self._occupied_dims()
        dim = self.dim
        if dim is None:
            dim = -1
            while dim in occupied:
                dim -= 1
        elif dim in occupied:
            raise ReproValueError(
                f"plate '{self.name}': dim {dim} already occupied by an "
                "enclosing plate", code="RPL002", site=self.name)
        indices = self._get_indices()  # the message runs before we join
        self._frame = CondIndepStackFrame(self._site_name, dim,
                                          self.subsample_size)
        _STACK.append(self)
        return indices

    def __exit__(self, *exc):
        pop_from_stack(self)
        self._frame = None
        return False

    def process_message(self, msg: dict) -> None:
        if msg["type"] == "subsample":
            self._subsample(msg)
            return
        if msg["type"] != "sample":
            return
        frame = self._frame
        msg["cond_indep_stack"].append(frame)
        if msg["value"] is None:
            fn = msg["fn"]
            batch_shape = tuple(getattr(fn, "batch_shape", ()))
            target = self._expanded_shape(msg["name"], batch_shape, frame.dim)
            if tuple(target) != batch_shape:
                msg["fn"] = fn.expand(tuple(target))
        else:
            event_dim = getattr(msg["fn"], "event_dim", 0)
            shape = _shape(msg["value"])
            batch_shape = shape[:len(shape) - event_dim]
            if len(batch_shape) >= -frame.dim \
                    and batch_shape[frame.dim] not in (1, self.subsample_size):
                raise ReproValueError(
                    f"sample site '{msg['name']}': observed value shape "
                    f"{shape} has extent {batch_shape[frame.dim]} at dim "
                    f"{frame.dim} of plate '{self.name}', which broadcasts "
                    "with neither 1 nor the plate extent "
                    f"{self.subsample_size}", code="RPL004", site=msg["name"])
        if self.size != self.subsample_size:
            scale = self.size / self.subsample_size
            msg["scale"] = scale if msg["scale"] is None else msg["scale"] * scale

    def _subsample(self, msg: dict) -> None:
        dim = self._frame.dim - msg["kwargs"].get("event_dim", 0)
        shape = _shape(msg["value"])
        if len(shape) < -dim:
            return  # the data does not span this plate's dim
        if shape[dim] == self.size:
            if self.subsample_size != self.size:
                value = msg["value"]
                indices = self._get_indices().to(value.device)
                msg["value"] = torch.index_select(value, dim % value.dim(),
                                                  indices)
        elif shape[dim] not in (1, self.subsample_size):
            # extent 1 broadcasts, as for sample sites (_expanded_shape)
            raise ReproValueError(
                f"subsample inside plate '{self.name}': axis {dim} of data "
                f"shape {shape} is {shape[dim]}, expected the full size "
                f"{self.size}, the subsample size {self.subsample_size}, or "
                "a broadcastable 1", code="RPL004", site=self.name)

    def postprocess_message(self, msg: dict) -> None:
        pass

    def _expanded_shape(self, site_name, batch_shape, dim):
        ndim = max(len(batch_shape), -dim)
        shape = [1] * ndim
        shape[len(shape) - len(batch_shape):] = list(batch_shape)
        if shape[dim] not in (1, self.subsample_size):
            raise ReproValueError(
                f"sample site '{site_name}': batch shape {tuple(batch_shape)} "
                f"has extent {shape[dim]} at dim {dim} of plate "
                f"'{self.name}', which broadcasts with neither 1 nor the "
                f"plate's subsample size {self.subsample_size}",
                code="RPL004", site=site_name)
        shape[dim] = self.subsample_size
        return shape
