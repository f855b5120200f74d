"""CLI for the port's static analyzer.

Single model::

    python -m repro_torch.lint <module-or-file.py>:<model> [--factory spec] \
        [--simulate] [--max-plate-nesting N] [--device cuda|cpu]

``--factory`` names a callable returning the model inputs: either
``(args, kwargs)`` or ``(model, args, kwargs)`` (the latter overrides the
positional target, for models built by closures).  The inputs move to
``--device`` (default ``cuda``; ``RPL502`` without a card) as ``MCMC``
moves them.

Corpus mode::

    python -m repro_torch.lint --corpus [--device cpu]

lints every model of ``repro_torch/bench/models.py`` at small data
(``logreg_model``, ``logreg_model_glm``, ``hmm_model``, ``enum_hmm_model``,
``skim_model``, ``eight_schools``, ``svi_logreg_model(n, B)``), runs the
metrics-stream rules (RPL401/402) over the NUTS, cross-chain NUTS, ChEES
and MALA setups and, on a card, the registry invariants RPL201-203 with
every kernel against its plain version.  The JAX package's corpus also
executes the fenced blocks of ``docs/lint.md``; those are JAX code, and
this corpus does not run them.  Exit code 0 means every model and setup
passed clean.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

from . import lint_model


def _load_module(spec: str):
    if spec.endswith(".py"):
        path = Path(spec)
        if not path.is_absolute():
            path = Path.cwd() / path
        name = "_lint_target_" + path.stem
        mspec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(mspec)
        sys.modules[name] = module
        mspec.loader.exec_module(module)
        return module
    return importlib.import_module(spec)


def _load_attr(target: str):
    module, sep, attr = target.partition(":")
    if not sep:
        raise SystemExit(f"target {target!r} must look like module:attr "
                         "or path.py:attr")
    return getattr(_load_module(module), attr)


def _report(label, result):
    print(f"[{'ok' if result.ok else 'FAIL'}] {label}")
    for finding in result.findings:
        print(f"    {finding}")
    return result.ok


def _corpus_entries():
    """(label, model, args, kwargs) for every model of
    ``repro_torch.bench.models``, at small data (numpy; the linter moves
    it to the device)."""
    from ..bench import models as bm

    cv = bm.covtype_data(n=200, d=8)
    yield ("bench/models.py:logreg_model", bm.logreg_model, (cv["x"],),
           {"y": cv["y"]})
    yield ("bench/models.py:logreg_model_glm", bm.logreg_model_glm,
           (cv["x"],), {"y": cv["y"]})
    yield ("bench/models.py:svi_logreg_model(200, 20)",
           bm.svi_logreg_model(200, 20), (cv["x"],), {"y": cv["y"]})
    yield ("bench/models.py:hmm_model", bm.hmm_model,
           (bm.hmm_data(T=60, T_sup=20),), {})
    yield ("bench/models.py:enum_hmm_model", bm.enum_hmm_model,
           (bm.enum_hmm_data(K=3, T=12),), {})
    sk = bm.skim_data(p=10, n=40)
    yield ("bench/models.py:skim_model", bm.skim_model, (sk["x"],),
           {"y": sk["y"]})
    es = bm.eight_schools_data()
    yield ("bench/models.py:eight_schools", bm.eight_schools,
           (es["sigma"],), {"y": es["y"]})


def _metrics_contract_entries(device):
    """(label, KernelSetup) for every kernel family declaring a
    ``metrics_fn``: corpus mode runs RPL401/402 over them."""
    import torch

    from ..bench import models as bm
    from ..core.infer import chees_setup, hmc_setup, mrw_setup
    from ..core.infer.mcmc import _to_device

    cv = bm.covtype_data(n=50, d=3)
    common = dict(model=bm.logreg_model,
                  model_args=_to_device((cv["x"],), device),
                  model_kwargs=_to_device({"y": cv["y"]}, device),
                  device=device)

    def gen():
        return torch.Generator().manual_seed(0)
    yield ("hmc_setup(NUTS).metrics_fn",
           hmc_setup(gen(), 10, algo="NUTS", **common))
    yield ("hmc_setup(NUTS, cross_chain_adapt).metrics_fn",
           hmc_setup(gen(), 10, algo="NUTS", cross_chain_adapt=True,
                     **common))
    yield ("chees_setup.metrics_fn", chees_setup(gen(), 10, **common))
    yield ("mrw_setup(MALA).metrics_fn",
           mrw_setup(gen(), 10, "MALA", **common))


def _corpus(device) -> int:
    from . import verify_metrics_fn, verify_registry

    ok = True
    for label, model, args, kwargs in _corpus_entries():
        ok &= _report(label, lint_model(model, args, kwargs, device=device))
    for label, setup in _metrics_contract_entries(device):
        ok &= _report(label, verify_metrics_fn(setup, num_chains=4))
    parity = device.type == "cuda"
    ok &= _report("kernels/ops.py registry (RPL201-20"
                  + ("3)" if parity else "2; RPL203 needs a card)"),
                  verify_registry(parity=parity, device=device))
    return 0 if ok else 1


def main(argv=None) -> int:
    from ..core.infer.hmc import resolve_device

    parser = argparse.ArgumentParser(prog="python -m repro_torch.lint",
                                     description=__doc__)
    parser.add_argument("target", nargs="?",
                        help="module:model or path.py:model")
    parser.add_argument("--factory",
                        help="module:fn returning (args, kwargs) or "
                        "(model, args, kwargs)")
    parser.add_argument("--simulate", action="store_true",
                        help="lint as a bare simulation (no implicit seed)")
    parser.add_argument("--max-plate-nesting", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the model's inputs go (default cuda)")
    parser.add_argument("--corpus", action="store_true",
                        help="lint every bench model and sampler setup")
    ns = parser.parse_args(argv)
    device = resolve_device(ns.device)

    if ns.corpus:
        return _corpus(device)
    if not ns.target:
        parser.error("a target (module:model) or --corpus is required")
    model = _load_attr(ns.target)
    args, kwargs = (), {}
    if ns.factory:
        produced = _load_attr(ns.factory)()
        if len(produced) == 3:
            model, args, kwargs = produced
        else:
            args, kwargs = produced
    mode = "simulate" if ns.simulate else "density"
    result = lint_model(model, args, kwargs, mode=mode,
                        max_plate_nesting=ns.max_plate_nesting,
                        device=device)
    return 0 if _report(ns.target, result) else 1


if __name__ == "__main__":
    sys.exit(main())
