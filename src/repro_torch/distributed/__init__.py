"""Distributed runtime of the port: checkpointing (``checkpoint``) and the
inference mesh's placements and collectives (``sharding``).

Submodules load lazily (PEP 562), as in the JAX package's
``repro.distributed``.
"""
from importlib import import_module

_SUBMODULES = ("checkpoint", "sharding")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        module = import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SUBMODULES))
