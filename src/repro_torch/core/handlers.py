"""Effect handlers (Table 1 of the paper, plus the extended set):
``trace``, ``replay``, ``seed``, ``substitute``, ``condition``, ``block``,
``mask``, ``scale``, ``do``, ``scope``, ``infer_config`` and ``reparam``.

A handler is a context manager that sits on the global stack and rewrites
the messages the primitives produce.  Each acts through one or both hooks:

- ``process_message`` runs innermost-handler-first, *before* the site value
  exists: values are injected (``replay``/``substitute``/``condition``/
  ``do``), names rewritten (``scope``), distributions replaced
  (``reparam``), generators handed out (``seed``), sites hidden (``block``)
  and density ``scale``/``mask`` accumulated (``scale``/``mask``/``plate``).
- ``postprocess_message`` runs outermost-first *after* the value exists:
  results are recorded (``trace``).

``scale`` and ``mask`` entries are consumed once, by
:func:`repro_torch.core.infer.util.log_density`, as
``where(mask, log_prob, 0) * scale``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from . import primitives
from .errors import ReproRuntimeError, ReproValueError
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


class replay(Messenger):
    """Replay sample statements against the values recorded in
    ``guide_trace``.

    Effect: ``process_message`` — injects the recorded value for matching
    latent ``sample`` sites (they stay latent) and for ``plate`` sites, so
    replaying a trace of a subsampled model reproduces its minibatch
    indices.  An observed site keeps its data.
    """

    def __init__(self, fn=None, guide_trace: Optional[dict] = None):
        super().__init__(fn)
        if guide_trace is None:
            raise ValueError("replay requires a guide_trace")
        self.guide_trace = guide_trace

    def process_message(self, msg: dict) -> None:
        name = msg["name"]
        if msg["type"] == "sample" and name in self.guide_trace:
            if msg["is_observed"]:
                return  # observed here: the data, not the recording, wins
            guide_msg = self.guide_trace[name]
            if guide_msg["type"] != "sample":
                raise ReproRuntimeError(
                    f"site {name} must be a sample site in the guide",
                    code="RPL011", site=name)
            if guide_msg["is_observed"]:
                # recorded as data but latent here: resampling silently would
                # score a different execution than the recording
                raise ReproRuntimeError(
                    f"site '{name}' was recorded as observed but is latent in "
                    "the replayed model; condition the model on the same data",
                    code="RPL011", site=name)
            msg["value"] = guide_msg["value"]
        elif msg["type"] == "plate" and name in self.guide_trace:
            guide_msg = self.guide_trace[name]
            if guide_msg["type"] == "plate":
                msg["value"] = guide_msg["value"]


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


# A deterministic site cannot take a value: it is computed, not drawn.  The
# common way to reach this is a handler outside a `reparam` that rewrote the
# site; dropping the data silently would evaluate the density elsewhere.
_REPARAMED_SITE_ERR = (
    "cannot {handler} deterministic site '{name}' (it is a computed value — "
    "likely a reparameterized site). Target its auxiliary sites instead "
    "(e.g. '{name}_decentered' / '{name}_base'), or drop the site's reparam "
    "strategy.")

# An enumerated site's value is its whole support broadcast into a fresh
# enumeration dim; overwriting it from outside the enum handler would
# corrupt the marginalization.
_ENUMERATED_SITE_ERR = (
    "cannot {handler} site '{name}': it is being enumerated (its value is "
    "the distribution's full support, not a free choice). Apply {handler} "
    "inside the enum handler, or drop the site's "
    "infer={{'enumerate': 'parallel'}} mark.")


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
        # pop first: a failed check must not leave the handler on the stack
        popped = super().__exit__(exc_type, exc_value, tb)
        if exc_type is None and self.strict and self.data is not None:
            _check_unmatched("substitute", self.data, self._seen)
        return popped

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
            if msg["infer"].get("reparamed"):
                # the value would be recomputed over our head
                raise ReproValueError(_REPARAMED_SITE_ERR.format(
                    handler="substitute", name=msg["name"]),
                    code="RPL007", site=msg["name"])
            return  # recomputed from the same substituted latents
        if msg["infer"].get("_enumerate_dim") is not None:
            raise ReproValueError(_ENUMERATED_SITE_ERR.format(
                handler="substitute", name=msg["name"]),
                code="RPL008", site=msg["name"])
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
        # pop first: a failed check must not leave the handler on the stack
        popped = super().__exit__(exc_type, exc_value, tb)
        if exc_type is None and self.strict:
            _check_unmatched("condition", self.data, self._seen)
        return popped

    def process_message(self, msg: dict) -> None:
        if msg["type"] == "deterministic" and msg["name"] in self.data \
                and msg["infer"].get("reparamed"):
            raise ReproValueError(_REPARAMED_SITE_ERR.format(
                handler="condition", name=msg["name"]),
                code="RPL007", site=msg["name"])
        if msg["type"] == "sample" and msg["name"] in self.data:
            if msg["infer"].get("_enumerate_dim") is not None:
                raise ReproValueError(_ENUMERATED_SITE_ERR.format(
                    handler="condition", name=msg["name"]),
                    code="RPL008", site=msg["name"])
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


class mask(Messenger):
    """Mask out (boolean) parts of a site's log density.

    Effect: ``process_message`` — ANDs the boolean ``mask`` into each
    sample message.  ``log_density`` zeroes masked elements before it
    applies ``scale``, so ``mask`` wins over ``scale`` in either nesting
    order (the two accumulate independently and commute).
    """

    def __init__(self, fn=None, mask=None):
        super().__init__(fn)
        self.mask = mask

    def process_message(self, msg: dict) -> None:
        if msg["type"] != "sample":
            return
        msg["mask"] = self.mask if msg["mask"] is None \
            else msg["mask"] & self.mask


class scale(Messenger):
    """Rescale the log density of enclosed sites (e.g. data subsampling).

    Effect: ``process_message`` — multiplies into each sample message's
    ``scale``, so nested ``scale`` handlers and subsampled plates compose
    multiplicatively.
    """

    def __init__(self, fn=None, scale=1.0):
        super().__init__(fn)
        self.scale_factor = scale

    def process_message(self, msg: dict) -> None:
        if msg["type"] != "sample":
            return
        msg["scale"] = (self.scale_factor if msg["scale"] is None
                        else self.scale_factor * msg["scale"])


class do(Messenger):
    """Intervention: clamp a sample site to a value without observing it,
    severing its dependence on upstream randomness (the causal
    ``do``-operator).

    Effect: ``process_message`` — sets the value and ``stop``s the message,
    so outer handlers (``trace`` too) never see the site; downstream code
    uses the clamped value.
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
        # pop first: a failed check must not leave the handler on the stack
        popped = super().__exit__(exc_type, exc_value, tb)
        if exc_type is None and self.strict:
            _check_unmatched("do", self.data, self._seen)
        return popped

    def process_message(self, msg: dict) -> None:
        if msg["type"] == "deterministic" and msg["name"] in self.data \
                and msg["infer"].get("reparamed"):
            raise ReproValueError(_REPARAMED_SITE_ERR.format(
                handler="do", name=msg["name"]),
                code="RPL007", site=msg["name"])
        if msg["type"] == "sample" and msg["name"] in self.data:
            if msg["infer"].get("_enumerate_dim") is not None:
                raise ReproValueError(_ENUMERATED_SITE_ERR.format(
                    handler="do", name=msg["name"]),
                    code="RPL008", site=msg["name"])
            self._seen.add(msg["name"])
            msg["value"] = self.data[msg["name"]]
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


class reparam(Messenger):
    """Reparameterize latent sample sites (see
    :mod:`repro_torch.core.reparam`).

    Effect: ``process_message`` — looks up a strategy for the site
    (``config`` is a dict ``name -> Reparam`` or a callable ``msg -> Reparam
    | None``) and calls it as ``new_fn, value = strategy(name, fn, obs)``.
    The strategy's auxiliary sample statements (e.g.
    ``f"{name}_decentered"``) re-enter the handler stack like any
    hand-written site.  If ``new_fn`` is None the site becomes a
    ``deterministic`` function of the auxiliaries, marked
    ``infer["reparamed"]`` so that outer ``substitute``/``condition``/``do``
    refuse it (RPL007) rather than drop their data.

    Compose ``reparam`` innermost (directly around the model).  Sites a
    strategy emits carry ``infer={"reparam_auxiliary": True}`` and are never
    reparameterized again, so a broad callable config terminates.
    """

    def __init__(self, fn=None, config=None):
        super().__init__(fn)
        if config is None or not (callable(config) or isinstance(config, dict)):
            raise ValueError("reparam requires a config dict or callable")
        self.config = config

    def process_message(self, msg: dict) -> None:
        if msg["type"] != "sample" or msg["infer"].get("reparam_auxiliary"):
            return
        if isinstance(self.config, dict):
            strategy = self.config.get(msg["name"])
        else:
            strategy = self.config(msg)
        if strategy is None:
            return
        if msg["value"] is not None and not msg["is_observed"]:
            # an inner substitute/replay pinned this site; sampling fresh
            # auxiliaries would evaluate the density elsewhere
            raise ValueError(
                f"site '{msg['name']}' has a substituted/replayed value but "
                "is configured for reparameterization — the strategy would "
                "ignore it. Pin the auxiliary sites (e.g. "
                f"'{msg['name']}_decentered' / '{msg['name']}_base') instead.")
        obs = msg["value"] if msg["is_observed"] else None
        new_fn, value = strategy(msg["name"], msg["fn"], obs)
        if new_fn is None:
            msg["type"] = "deterministic"
            msg["value"] = value
            msg["is_observed"] = False
            msg["fn"] = lambda *a, **kw: value
            msg["args"] = ()
            msg["kwargs"] = {}
            msg["infer"]["reparamed"] = True
            return
        msg["fn"] = new_fn
        if value is not None:
            msg["value"] = value


__all__ = ["Messenger", "trace", "replay", "seed", "substitute", "condition",
           "block", "mask", "scale", "do", "scope", "infer_config",
           "reparam"]
