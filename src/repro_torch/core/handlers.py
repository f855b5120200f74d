"""Effect handlers: ``trace``, ``seed``, ``substitute``, ``condition``,
``block``, ``scope`` and ``infer_config`` (Table 1 of the paper).

A handler is a context manager that sits on the global stack and rewrites
the messages the primitives produce.  Each acts through one or both hooks:

- ``process_message`` runs innermost-handler-first, *before* the site value
  exists: values are injected (``substitute``/``condition``), generators
  handed out (``seed``), sites hidden (``block``).
- ``postprocess_message`` runs outermost-first *after* the value exists:
  results are recorded (``trace``).

``replay``, ``mask``, ``scale``, ``do`` and ``reparam`` are still to be
ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from . import primitives
from .errors import ReproValueError
from .primitives import stack


class Messenger:
    def __init__(self, fn: Optional[Callable] = None):
        self.fn = fn

    def __enter__(self):
        stack().append(self)
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is None and stack()[-1] is not self:
            raise RuntimeError("handler stack corrupted: exiting a handler "
                               "that is not on top")
        primitives.pop_from_stack(self)
        return False

    def process_message(self, msg: dict) -> None:  # innermost -> outermost
        pass

    def postprocess_message(self, msg: dict) -> None:  # outermost -> innermost
        pass

    def __call__(self, *args, **kwargs):
        if self.fn is None:
            raise ValueError("handler has no wrapped function to call")
        with self:
            return self.fn(*args, **kwargs)


class trace(Messenger):
    """Record every ``sample``/``param``/``deterministic``/``plate`` site
    into an :class:`OrderedDict` (``postprocess_message``).  Never alters
    values, scales or masks."""

    def __enter__(self):
        super().__enter__()
        self._trace = OrderedDict()
        return self._trace

    def postprocess_message(self, msg: dict) -> None:
        name = msg["name"]
        if msg["type"] in ("sample", "param", "deterministic", "plate"):
            if name in self._trace:
                raise ReproValueError(
                    f"duplicate site name '{name}' in trace: every sample/"
                    "param/deterministic/plate statement in one model "
                    "execution needs a unique name.", code="RPL001", site=name)
            self._trace[name] = msg.copy()

    def get_trace(self, *args, **kwargs) -> OrderedDict:
        self(*args, **kwargs)
        return self._trace


def _as_generator(rng_seed) -> torch.Generator:
    if isinstance(rng_seed, torch.Generator):
        return rng_seed
    if isinstance(rng_seed, int):
        return torch.Generator().manual_seed(rng_seed)
    raise ValueError("seed requires a torch.Generator or an int seed")


class seed(Messenger):
    """Seed ``fn`` with a ``torch.Generator`` (or an int that seeds a new
    one on the CPU).

    Effect: ``process_message`` — every unvalued ``sample`` site, lazily
    initialized ``param`` site and subsampled ``plate`` index draw that has
    no generator of its own draws from this one, in program order.  Draws
    are made on the CPU and moved to the parameters' device, so a seed gives
    the same values on every device.
    """

    def __init__(self, fn=None, rng_seed=None):
        super().__init__(fn)
        if rng_seed is None:
            raise ValueError("seed requires a torch.Generator or int seed")
        self.generator = _as_generator(rng_seed)

    def process_message(self, msg: dict) -> None:
        if msg["kwargs"].get("generator") is not None:
            return
        if (msg["type"] == "sample" and not msg["is_observed"]) or (
                msg["type"] in ("plate", "param") and msg["value"] is None):
            gen = self.generator
            msg["kwargs"]["generator"] = gen
            if msg["type"] == "param" and msg["kwargs"].get("shape") is not None:
                init_fn = msg["kwargs"].get("init_fn") or _default_param_init
                shape = msg["kwargs"]["shape"]
                dtype = msg["kwargs"].get("dtype", torch.float32)
                msg["fn"] = lambda *a, **kw: init_fn(gen, shape, dtype)


def _default_param_init(generator, shape, dtype):
    if len(shape) == 0:
        return torch.zeros(shape, dtype=dtype)
    fan_in = shape[-1] if len(shape) == 1 else shape[-2]
    scale = 1.0 / max(fan_in, 1) ** 0.5
    return (torch.randn(shape, generator=generator) * scale).to(dtype)


def _check_unmatched(handler: str, data: Dict, seen: set) -> None:
    """RPL006 runtime twin: a data key that matched no site is almost always
    a typo'd name or a site the handler cannot see."""
    missing = sorted(set(data) - seen)
    if missing:
        raise ReproValueError(
            f"{handler} data key(s) {missing} matched no site in the model "
            "execution: check the name(s) against trace(model).get_trace() "
            "(blocked sites are invisible to outer handlers).",
            code="RPL006", site=missing[0])


class substitute(Messenger):
    """Substitute values for ``sample``/``param``/``plate`` sites.

    Effect: ``process_message`` — sets ``msg['value']`` from ``data`` (or
    ``substitute_fn(msg)``).  Unlike :class:`condition`, substituted sample
    sites stay *unobserved*: they are scored as latents, which is how
    inference evaluates the density at a proposed point.
    """

    def __init__(self, fn=None, data: Optional[Dict] = None,
                 substitute_fn: Optional[Callable] = None,
                 strict: bool = False):
        super().__init__(fn)
        if (data is None) == (substitute_fn is None):
            raise ValueError("substitute requires exactly one of data / substitute_fn")
        if strict and data is None:
            raise ValueError("substitute(strict=True) requires a data dict")
        self.data = data
        self.substitute_fn = substitute_fn
        self.strict = strict
        self._seen = set()

    def __enter__(self):
        self._seen = set()
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is None and self.strict and self.data is not None:
            _check_unmatched("substitute", self.data, self._seen)
        return super().__exit__(exc_type, exc_value, tb)

    def process_message(self, msg: dict) -> None:
        if msg["type"] not in ("sample", "param", "plate", "deterministic"):
            return
        if self.data is not None:
            value = self.data.get(msg["name"])
        else:
            value = self.substitute_fn(msg)
        if value is None:
            return
        self._seen.add(msg["name"])
        if msg["type"] == "deterministic":
            return  # recomputed from the same substituted latents
        msg["value"] = value


class condition(Messenger):
    """Condition unobserved sample sites on the given values.

    Effect: ``process_message`` — sets the value *and* marks the site
    observed, so it is scored as data and ``seed`` stops treating it as a
    draw.
    """

    def __init__(self, fn=None, data: Optional[Dict] = None,
                 strict: bool = False):
        super().__init__(fn)
        self.data = data or {}
        self.strict = strict
        self._seen = set()

    def __enter__(self):
        self._seen = set()
        return super().__enter__()

    def __exit__(self, exc_type, exc_value, tb):
        if exc_type is None and self.strict:
            _check_unmatched("condition", self.data, self._seen)
        return super().__exit__(exc_type, exc_value, tb)

    def process_message(self, msg: dict) -> None:
        if msg["type"] == "sample" and msg["name"] in self.data:
            self._seen.add(msg["name"])
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class block(Messenger):
    """Hide selected sites from outer handlers.

    Effect: ``process_message`` — sets ``msg['stop'] = True`` for matching
    sites: an outer ``trace`` won't record them, an outer ``seed`` won't
    hand them a generator.  Handlers inside the block still see them.
    """

    def __init__(self, fn=None, hide_fn: Optional[Callable] = None,
                 hide: Optional[list] = None, expose: Optional[list] = None):
        super().__init__(fn)
        if hide_fn is not None:
            self.hide_fn = hide_fn
        elif hide is not None:
            self.hide_fn = lambda msg: msg["name"] in hide
        elif expose is not None:
            self.hide_fn = lambda msg: msg["name"] not in expose
        else:
            self.hide_fn = lambda msg: True

    def process_message(self, msg: dict) -> None:
        if self.hide_fn(msg):
            msg["stop"] = True


class scope(Messenger):
    """Prefix every interior site name with ``prefix + divider``.

    Effect: ``process_message`` — rewrites ``msg['name']`` for all named
    message types (``sample``/``param``/``deterministic``/``plate``), which
    lets one model be instantiated several times in a larger program without
    site-name collisions.  Nested scopes compose outside-in:
    ``scope(scope(f, prefix='a'), prefix='b')`` yields ``b/a/site``.
    """

    def __init__(self, fn=None, prefix: str = "", divider: str = "/"):
        super().__init__(fn)
        if not prefix:
            raise ValueError("scope requires a non-empty prefix")
        self.prefix = prefix
        self.divider = divider

    def process_message(self, msg: dict) -> None:
        if msg["type"] in ("sample", "param", "deterministic", "plate"):
            msg["name"] = f"{self.prefix}{self.divider}{msg['name']}"


class infer_config(Messenger):
    """Update per-site inference configuration.

    Effect: ``process_message`` — for ``sample``/``param`` sites, merges
    ``config_fn(msg)`` (a dict, may be empty) into ``msg['infer']``.
    Values never affect the density.
    """

    def __init__(self, fn=None, config_fn: Optional[Callable] = None):
        super().__init__(fn)
        if config_fn is None:
            raise ValueError("infer_config requires a config_fn")
        self.config_fn = config_fn

    def process_message(self, msg: dict) -> None:
        if msg["type"] in ("sample", "param"):
            extra = self.config_fn(msg)
            if extra:
                msg["infer"].update(extra)


__all__ = ["Messenger", "trace", "seed", "substitute", "condition", "block",
           "scope", "infer_config"]
