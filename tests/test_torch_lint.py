"""The port's static analyzer (``repro_torch.lint``) against the JAX
package's (``repro.lint``).

- The 15-defect corpus of ``tests/test_lint.py``, written once and built in
  each package: every defect gives the same code, site and severity from
  both linters, and every RPL0xx rule is covered.  The clean corpus is
  clean in both, and the port's ``--corpus`` CLI returns 0 on the CPU.
- The abstract pass: meta tensors where the reference takes
  ``ShapeDtypeStruct``s.
- RPL101-104 on the reference's cases, each with a negative case; a
  sanctioned ``.item()`` does not fire RPL102; the markov HMM density has
  the same op count at T = 4 and 8, an unrolled loop does not.
- RPL201/202 clean over the port's tables (after the repairs of the
  ``nuts_turning`` signatures, ``flash_attention_cuda``'s ``window``, the
  ``mla_absorbed_decode`` row and the ``enum_chain_alphas`` entry), planted
  drifts caught; RPL203 raises RPL502 without a card; RPL204 on a real
  NUTS setup and each violation.
- ``validate=`` on ``MCMC`` and ``SVI``; ``rng_dependent_metrics``.
- ``mla_absorbed_decode`` against the reference's jnp version.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

import repro.core as jpc
import repro.core.handlers as jhandlers
import repro.kernels.ops as jops
import repro.lint as jlint
from repro.core import dist as jdist
from repro.core.infer import markov as jmarkov
from repro.core.reparam import LocScaleReparam as JLocScaleReparam
from repro.kernels import ref as jref
import repro_torch.core as pc
import repro_torch.core.handlers as handlers
import repro_torch.lint as lint
import repro_torch.lint_rules.invariants as inv
from repro_torch import obs
from repro_torch.core import dist
from repro_torch.core.errors import ReproError
from repro_torch.core.infer import (MCMC, NUTS, SVI, Trace_ELBO, log_density,
                                    markov)
from repro_torch.core.reparam import LocScaleReparam
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.optim import adam


class Pkg(NamedTuple):
    """One package's names, so each defect is written once."""
    pc: object
    dist: object
    h: object                 # the handlers module
    loc_scale: Callable
    markov: Callable
    lint_model: Callable
    arr: Callable             # numpy -> the package's array
    key: Callable             # int -> what its ``seed`` takes


JAX = Pkg(jpc, jdist, jhandlers, JLocScaleReparam, jmarkov, jlint.lint_model,
          jnp.asarray, jax.random.PRNGKey)
TORCH = Pkg(pc, dist, handlers, LocScaleReparam, markov,
            functools.partial(lint.lint_model, device="cpu"),
            torch.as_tensor, int)
PKGS = {"jax": JAX, "torch": TORCH}


# ---------------------------------------------------------------------------
# the defective-model corpus: one entry per RPL0xx rule
# ---------------------------------------------------------------------------

def _f32(*shape):
    return np.zeros(shape, np.float32)


def _dup_site(P):
    def model():
        P.pc.sample("w", P.dist.Normal(0.0, 1.0))
        P.pc.sample("w", P.dist.Normal(0.0, 1.0))
    return model, (), {}, {}


def _plate_dim_collision(P):
    def model():
        with P.pc.plate("a", 3, dim=-1), P.pc.plate("b", 4, dim=-1):
            P.pc.sample("x", P.dist.Normal(0.0, 1.0))
    return model, (), {}, {}


def _enum_budget_overflow(P):
    def model(x):
        mu = P.pc.sample("mu", P.dist.Normal(P.arr(_f32(2)), 1.0)
                         .to_event(1))
        with P.pc.plate("data", x.shape[0]):
            z = P.pc.sample("z", P.dist.Categorical(
                probs=P.arr(np.full(2, 0.5, np.float32))),
                infer={"enumerate": "parallel"})
            P.pc.sample("obs", P.dist.Normal(mu[z], 1.0), obs=x)
    return model, (P.arr(_f32(5)),), {}, {"max_plate_nesting": 0}


def _plate_shape_mismatch(P):
    def model():
        with P.pc.plate("data", 5):
            P.pc.sample("obs", P.dist.Normal(0.0, 1.0), obs=P.arr(_f32(7)))
    return model, (), {}, {}


def _obs_outside_support(P):
    def model():
        P.pc.sample("x", P.dist.Beta(2.0, 2.0),
                    obs=P.arr(np.float32(1.5)))
    return model, (), {}, {}


def _dead_substitute_key(P):
    def model():
        P.pc.sample("mu", P.dist.Normal(0.0, 1.0))
    return P.h.substitute(model, data={"mu_typo": P.arr(np.float32(0.3))}), \
        (), {}, {}


def _substitute_reparamed_site(P):
    def model():
        mu = P.pc.sample("mu", P.dist.Normal(0.0, 1.0))
        P.pc.sample("x", P.dist.Normal(mu, 2.0))
    wrapped = P.h.substitute(
        P.h.reparam(model, config={"x": P.loc_scale(0.0)}),
        data={"x": P.arr(np.float32(0.5))})
    return wrapped, (), {}, {}


def _enum_model(P):
    def model():
        z = P.pc.sample("z", P.dist.Categorical(
            probs=P.arr(np.full(3, 1 / 3, np.float32))),
            infer={"enumerate": "parallel"})
        means = P.arr(np.arange(3.0, dtype=np.float32))
        P.pc.sample("obs", P.dist.Normal(means[z], 1.0),
                    obs=P.arr(np.float32(1.0)))
    return model


def _param_on_enumerated_site(P):
    return _enum_model(P), (), {}, {"params": {"z": P.arr(np.int64(1))}}


def _unseeded_latent(P):
    def model():
        P.pc.sample("mu", P.dist.Normal(0.0, 1.0))
    return model, (), {}, {"mode": "simulate"}


def _float64_observation(P):
    def model(y):
        mu = P.pc.sample("mu", P.dist.Normal(0.0, 1.0))
        P.pc.sample("obs", P.dist.Normal(mu, 1.0), obs=y)
    return model, (np.zeros(4, dtype=np.float64),), {}, {}


def _replay_observed_latent_mismatch(P):
    def model():
        P.pc.sample("x", P.dist.Normal(0.0, 1.0))
    observed = P.h.condition(model, data={"x": P.arr(np.float32(0.3))})
    observed_tr = P.h.trace(P.h.seed(observed, P.key(0))).get_trace()
    return P.h.replay(model, guide_trace=observed_tr), (), {}, {}


def _unseeded_subsample(P):
    def model(x):
        with P.pc.plate("data", x.shape[0], subsample_size=2):
            xb = P.pc.subsample(x, event_dim=0)
            P.pc.sample("obs", P.dist.Normal(0.0, 1.0), obs=xb)
    return model, (P.arr(_f32(6)),), {}, {"mode": "simulate"}


def _enumerate_continuous_site(P):
    def model():
        P.pc.sample("x", P.dist.Normal(0.0, 1.0),
                    infer={"enumerate": "parallel"})
        P.pc.sample("obs", P.dist.Normal(0.0, 1.0),
                    obs=P.arr(np.float32(0.5)))
    return model, (), {}, {}


def _markov_inside_plate(P):
    def step(carry, x_t):
        z = P.pc.sample("z", P.dist.Categorical(
            probs=P.arr(np.full(2, 0.5, np.float32))),
            infer={"enumerate": "parallel"})
        P.pc.sample("obs", P.dist.Normal(z * 1.0, 1.0), obs=x_t)
        return z

    def model(x):
        with P.pc.plate("outer", 4):
            P.markov(step, 0, x)
    return model, (P.arr(_f32(3)),), {}, {}


def _seed_baked_into_model(P):
    def model():
        P.pc.sample("mu", P.dist.Normal(0.0, 1.0))
        P.pc.sample("obs", P.dist.Normal(0.0, 1.0),
                    obs=P.arr(np.float32(0.5)))
    return P.h.seed(model, P.key(0)), (), {}, {}


class Defect(NamedTuple):
    code: str
    site: Optional[str]      # expected Finding.site (None: no single site)
    expect: str              # fragment that must appear in str(finding)
    build: Callable          # Pkg -> (model, args, kwargs, lint_kwargs)


DEFECTS = [
    Defect("RPL001", "w", "'w'", _dup_site),
    Defect("RPL002", "b", "'b'", _plate_dim_collision),
    Defect("RPL003", None, "max_plate_nesting", _enum_budget_overflow),
    Defect("RPL004", "obs", "'obs'", _plate_shape_mismatch),
    Defect("RPL005", "x", "'x'", _obs_outside_support),
    Defect("RPL006", "mu_typo", "'mu_typo'", _dead_substitute_key),
    Defect("RPL007", "x", "'x'", _substitute_reparamed_site),
    Defect("RPL008", "z", "'z'", _param_on_enumerated_site),
    Defect("RPL009", "mu", "'mu'", _unseeded_latent),
    Defect("RPL010", "obs", "'obs'", _float64_observation),
    Defect("RPL011", "x", "'x'", _replay_observed_latent_mismatch),
    Defect("RPL012", None, "subsample", _unseeded_subsample),
    Defect("RPL013", "x", "'x'", _enumerate_continuous_site),
    Defect("RPL014", "outer", "'outer'", _markov_inside_plate),
    Defect("RPL015", None, "seed", _seed_baked_into_model),
]


@pytest.mark.parametrize("defect", DEFECTS, ids=[d.code for d in DEFECTS])
def test_defect_fires_with_the_same_code_site_and_severity(defect):
    got = {}
    for label, P in PKGS.items():
        model, args, kwargs, lint_kwargs = defect.build(P)
        result = P.lint_model(model, args, kwargs, **lint_kwargs)
        assert defect.code in result.codes(), (label, result.findings)
        finding = next(f for f in result.findings if f.code == defect.code)
        assert defect.expect in str(finding), (label, finding)
        got[label] = (finding.code, finding.site, finding.severity)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == defect.site
    assert got["torch"][2] == lint.RULES[defect.code].severity


def test_rules_match_the_reference_registry():
    """Every code of the reference's registry, with its severity and twin;
    every RPL0xx rule has a corpus entry; a rule without a runtime twin
    says why."""
    assert set(lint.RULES) == set(jlint.RULES)
    for code, rule in lint.RULES.items():
        ref = jlint.RULES[code]
        assert (rule.severity, rule.twin) == (ref.severity, ref.twin), code
        assert lint.rule(code) is rule
        assert rule.justification if rule.twin is None else \
            rule.twin in ("error", "warning")
    assert {c for c in lint.RULES if c.startswith("RPL0")} \
        == {d.code for d in DEFECTS}


def test_lint_result_raise_if_errors_and_the_cli(tmp_path):
    from repro_torch.lint.__main__ import main
    model, args, kwargs, lint_kwargs = _dup_site(TORCH)
    result = TORCH.lint_model(model, args, kwargs, **lint_kwargs)
    with pytest.raises(ValueError, match=r"\[RPL001\]") as ei:
        result.raise_if_errors()
    assert isinstance(ei.value, ReproError) and ei.value.code == "RPL001"
    clean = TORCH.lint_model(
        lambda: pc.sample("obs", dist.Normal(0.0, 1.0),
                          obs=torch.tensor(0.5)))
    assert clean.raise_if_errors() is clean and not clean.findings
    target = tmp_path / "targets.py"
    target.write_text(
        "import torch\n"
        "import repro_torch.core as pc\n"
        "from repro_torch.core import dist\n\n"
        "def bad():\n"
        "    pc.sample('w', dist.Normal(0.0, 1.0))\n"
        "    pc.sample('w', dist.Normal(0.0, 1.0))\n\n"
        "def good(y):\n"
        "    mu = pc.sample('mu', dist.Normal(0.0, 1.0))\n"
        "    pc.sample('obs', dist.Normal(mu, 1.0), obs=y)\n\n"
        "def make_args():\n"
        "    return (torch.tensor(0.5),), {}\n")
    assert main([f"{target}:bad", "--device", "cpu"]) == 1
    assert main([f"{target}:good", "--factory", f"{target}:make_args",
                 "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# clean models: no false positives on either package's corpus
# ---------------------------------------------------------------------------

def _struct(value):
    if isinstance(value, (np.ndarray, jax.Array)):
        return jax.ShapeDtypeStruct(value.shape, value.dtype)
    if isinstance(value, dict):
        return {k: _struct(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_struct(v) for v in value)
    return value


def test_corpora_lint_clean_in_both_packages():
    """The port's corpus (every model of ``repro_torch.bench.models`` at
    small data) is clean, also through ``main(["--corpus"])``; the
    reference's counterparts (``benchmarks/models.py``, the eight schools
    example) are clean at the same data, abstractly (``ShapeDtypeStruct``s:
    the reference's eager data recipes and op-by-op compiles would take
    most of this file's time; ``tests/test_lint.py`` lints them
    concretely)."""
    import sys
    from pathlib import Path

    from repro.lint.__main__ import _example
    from repro_torch.lint.__main__ import _corpus_entries, main
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import models as jbm
    reference = {"logreg_model": jbm.logreg_model,
                 "logreg_model_glm": jbm.logreg_model_glm,
                 "hmm_model": jbm.hmm_model,
                 "enum_hmm_model": jbm.enum_hmm_model,
                 "skim_model": jbm.skim_model}
    labels = []
    for label, model, args, kwargs in _corpus_entries():
        result = lint.lint_model(model, args, kwargs, device="cpu")
        assert result.ok and not result.findings, f"{label}:\n{result}"
        labels.append(label)
        j_model = reference.get(label.split(":")[1])
        if j_model is not None:
            result = jlint.lint_model(j_model, _struct(args),
                                      _struct(kwargs))
            assert result.ok and not result.findings, f"ref {label}"
            labels.append(j_model.__name__)
    es = _example("eight_schools")
    assert not jlint.lint_model(es.eight_schools, (),
                                {"y": _struct(es.y)}).findings
    assert len(labels) == 7 + 5
    assert main(["--corpus", "--device", "cpu"]) == 0


def test_lint_on_meta_tensors_is_abstract():
    """Meta tensors stand in for the reference's ShapeDtypeStructs:
    structural rules still fire, value rules skip the abstract data."""
    def dup(x):
        pc.sample("w", dist.Normal(0.0, 1.0))
        pc.sample("w", dist.Normal(0.0, 1.0))
        pc.sample("obs", dist.Normal(0.0, 1.0), obs=x)

    def badobs(x):
        pc.sample("x", dist.Beta(2.0, 2.0), obs=x)

    meta = torch.empty(4, device="meta")
    assert "RPL001" in lint.lint_model(dup, (meta,)).codes()
    assert "RPL005" not in lint.lint_model(
        badobs, (torch.empty((), device="meta"),)).codes()
    assert "RPL005" in lint.lint_model(badobs, (torch.tensor(1.5),),
                                       device="cpu").codes()
    # the reference's verdict on its abstract input
    struct = jax.ShapeDtypeStruct((4,), jnp.float32)
    assert "RPL001" in jlint.lint_model(_jdup, (struct,)).codes()
    # the three paper models on meta tensors, the logreg at full width:
    # clean, their latents drawn abstractly
    from repro_torch.bench import models as bm
    hmm = _meta(bm.hmm_data(T=60, T_sup=20))
    sk = bm.skim_data(p=16, n=20)
    for model, args, kwargs in (
            (bm.logreg_model_glm, (torch.empty(581_012, 54, device="meta"),),
             {"y": torch.empty(581_012, device="meta")}),
            (bm.hmm_model, (hmm,), {}),
            (bm.skim_model, (_meta(sk["x"]),), {"y": _meta(sk["y"])})):
        result = lint.lint_model(model, args, kwargs)
        assert result.ok and not result.findings, (model.__name__, result)


def _meta(value):
    """numpy arrays as empty meta tensors of their shape and dtype."""
    return tree_map(lambda leaf: torch.empty(
        leaf.shape, dtype=torch.from_numpy(leaf).dtype, device="meta")
        if isinstance(leaf, np.ndarray) else leaf, value)


def _jdup(x):
    jpc.sample("w", jdist.Normal(0.0, 1.0))
    jpc.sample("w", jdist.Normal(0.0, 1.0))
    jpc.sample("obs", jdist.Normal(0.0, 1.0), obs=x)


def test_lint_leaves_the_global_generators_alone():
    def model():
        pc.sample("mu", dist.Normal(0.0, 1.0))
        torch.randn(3)  # a model that draws from the global generator
    state = torch.get_rng_state()
    assert TORCH.lint_model(model).ok
    assert torch.equal(torch.get_rng_state(), state)


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds where there "
                    "is no card")
def test_lint_model_runs_on_the_card_unless_asked_for_the_cpu():
    """Concrete arguments move to the card by default (RPL502 without
    one); meta arguments need no device, and device="cpu" lints on the
    CPU."""
    def model(x):
        pc.sample("obs", dist.Normal(0.0, 1.0), obs=x)
    x = np.zeros(3, np.float32)
    with pytest.raises(ReproError, match="RPL502") as ei:
        lint.lint_model(model, (x,))
    assert ei.value.code == "RPL502"
    assert lint.lint_model(model, (torch.empty(3, device="meta"),)).ok
    assert lint.lint_model(model, (x,), device="cpu").ok


# ---------------------------------------------------------------------------
# RPL1xx: hazards in the dispatched ops
# ---------------------------------------------------------------------------

def test_analyze_flags_a_large_closed_over_tensor():
    big = torch.zeros(400_000)  # 1.6 MB closed over, not passed in

    def fn(x):
        return (x + big).sum()

    x = torch.zeros(400_000)
    assert "RPL101" in lint.analyze(fn, x).codes()
    j_big = jnp.zeros(400_000)
    assert "RPL101" in jlint.analyze(lambda v: (v + j_big).sum(),
                                     jnp.zeros(400_000)).codes()
    # raising the limit clears it; passing the tensor as an argument too
    assert "RPL101" not in lint.analyze(fn, x,
                                        const_bytes_limit=1 << 24).codes()
    assert "RPL101" not in lint.analyze(lambda a, c: (a + c).sum(), x,
                                        torch.zeros(400_000)).codes()
    # a view of an argument is the argument's
    assert "RPL101" not in lint.analyze(lambda a: (a[1:] * 2).sum(),
                                        x).codes()


def test_analyze_flags_a_host_read_unless_sanctioned():
    def fn(x):
        return torch.sin(x).sum().item()

    result = lint.analyze(fn, torch.zeros(4))
    assert "RPL102" in result.codes() and "test_torch_lint.py" in str(result)
    assert "RPL102" in jlint.analyze(
        lambda v: jax.pure_callback(np.sin, jax.ShapeDtypeStruct(
            (4,), jnp.float32), v).sum(), jnp.zeros(4)).codes()
    assert "RPL102" not in lint.analyze(lambda x: torch.sin(x).sum(),
                                        torch.zeros(4)).codes()
    assert "RPL102" in lint.analyze(lambda x: x[x > 0].sum(),
                                    torch.ones(4)).codes()

    @obs.sanction
    def drain(v):
        return v.sum().item()

    assert obs.is_sanctioned(drain) and not obs.is_sanctioned(fn)
    assert "RPL102" not in lint.analyze(lambda x: drain(torch.sin(x)),
                                        torch.zeros(4)).codes()


def test_analyze_flags_precision_narrowing():
    x = torch.zeros(8)
    assert "RPL103" in lint.analyze(lambda v: v.half().sum(), x).codes()
    assert "RPL103" in jlint.analyze(lambda v: v.astype(jnp.float16).sum(),
                                     jnp.zeros(8, jnp.float32)).codes()
    assert "RPL103" in lint.analyze(lambda v: v.float().sum(),
                                    x.double()).codes()
    assert "RPL103" not in lint.analyze(lambda v: v.double().sum(),
                                        x).codes()
    assert not lint.analyze(lambda v: v.sum(), x).findings


def _markov_log_density_at(T):
    xs = torch.zeros(T)
    trans = torch.tensor([[0.8, 0.2], [0.3, 0.7]])

    def step(carry, x_t):
        z = pc.sample("z", dist.Categorical(probs=trans[carry]),
                      infer={"enumerate": "parallel"})
        pc.sample("x", dist.Normal(z * 1.0, 1.0), obs=x_t)
        return z

    def model():
        markov(step, 0, xs)

    def fn(mu0):
        mu0 = mu0.clone().requires_grad_()
        lp = log_density(model, (), {}, {})[0] + mu0
        return lp, torch.autograd.grad(lp, mu0)
    return fn, (torch.zeros(()),)


def test_markov_density_is_time_independent_and_a_loop_is_not():
    """The markov HMM density and its gradient dispatch as many ops at
    T = 4 as at T = 8 (the chain is one ops.enum_chain node, on the CPU its
    plain loop included); a Python loop over time steps fires RPL104, in
    both packages."""
    result = lint.check_time_independence(_markov_log_density_at, (4, 8))
    assert result.ok and not result.findings, result

    def unrolled(T):
        xs = torch.zeros(T)

        def fn(mu):
            lp = torch.zeros(())
            for t in range(T):
                lp = lp + dist.Normal(mu, 1.0).log_prob(xs[t])
            return lp
        return fn, (torch.zeros(()),)

    def j_unrolled(T):
        xs = jnp.zeros(T)

        def fn(mu):
            lp = jnp.zeros(())
            for t in range(T):
                lp = lp + jdist.Normal(mu, 1.0).log_prob(xs[t])
            return lp
        return fn, (jnp.zeros(()),)

    for check, make in ((lint.check_time_independence, unrolled),
                        (jlint.check_time_independence, j_unrolled)):
        result = check(make, sizes=(4, 8))
        assert "RPL104" in result.codes() and not result.ok


# ---------------------------------------------------------------------------
# RPL2xx: the op registry and KernelSetup invariants
# ---------------------------------------------------------------------------

ROWS = list(ops.OP_TABLE) + list(ops.FUSED.values()) \
    + list(ops.BACKWARD.values())


def test_op_table_matches_the_reference_and_the_registry_is_clean():
    assert [(s.name, s.bit_identical, s.tol) for s in ops.OP_TABLE] == \
        [(s.name, s.bit_identical, s.tol) for s in jops.OP_TABLE]
    assert len(ROWS) == 12 + len(ops.FUSED) + len(ops.BACKWARD)
    assert sum(s.kernel is not None for s in ROWS) == 9 + 11 + 6
    result = lint.verify_registry(parity=False)
    assert result.ok and not result.findings, result
    for spec in ROWS:
        assert inv._sample_inputs(spec.name, torch.device("cpu")) \
            is not None or spec.kernel is None, spec.name


def test_planted_signature_drift_is_caught():
    bogus = ops.SPECS["rmsnorm"]._replace(
        kernel=ops.SPECS["leapfrog_halfstep"].kernel)
    assert "RPL202" in lint.check_signatures(bogus).codes()


def test_extra_kernel_parameter_needs_a_default():
    def kernel(x, weight, eps=1e-6, *, block):
        raise AssertionError
    spec = ops.SPECS["rmsnorm"]._replace(kernel=kernel)
    result = lint.check_signatures(spec)
    assert [(f.code, f.site) for f in result.findings] == [
        ("RPL202", "rmsnorm")] and "'block'" in str(result)


@pytest.mark.parametrize("row,kernel", [
    ("nuts_turning", lambda m_inv, r_left, r_right, r_sum: None),
    ("nuts_turning_batch", lambda m_inv, r_left, r_right, r_sum: None),
    ("attention", lambda q, k, v, causal=True, scale=None: None)])
def test_repaired_signature_rows_and_their_old_forms(row, kernel):
    """The three rows RPL202 found before the repairs: clean now, and the
    old kernel signature (``m_inv`` first; no ``window``) still caught."""
    table = ops.FUSED if row in ops.FUSED else ops.SPECS
    assert lint.check_signatures(table[row]).ok
    old = table[row]._replace(kernel=kernel)
    assert [f.code for f in lint.check_signatures(old).findings] \
        == ["RPL202"]
    if row == "attention":
        q = torch.zeros(1, 4, 2, 8)
        with pytest.raises(ValueError, match="window"):
            flash.flash_attention_cuda(q, q, q, window=2)


def test_repaired_registry_rows_and_a_stale_row(monkeypatch):
    """``mla_absorbed_decode`` has its plain version and public op;
    ``enum_chain_alphas`` is an entry of ``enum_chain``'s row; each
    drift back, and a stale row, is caught as RPL201."""
    assert lint.check_registry_completeness().ok
    assert ops.FUSED["enum_chain"].also == ("enum_chain_alphas",)
    fused = dict(ops.FUSED)
    fused["enum_chain"] = fused["enum_chain"]._replace(also=())
    monkeypatch.setattr(ops, "FUSED", fused)
    result = lint.check_registry_completeness()
    assert [(f.code, f.site) for f in result.findings] == [
        ("RPL201", "enum_chain_alphas")]
    monkeypatch.undo()
    table = tuple(s._replace(ref=None) if s.name == "mla_absorbed_decode"
                  else s for s in ops.OP_TABLE) + (
        ops.SPECS["rmsnorm"]._replace(name="no_such_op"),)
    monkeypatch.setattr(ops, "OP_TABLE", table)
    sites = {(f.code, f.site)
             for f in lint.check_registry_completeness().findings}
    assert sites == {("RPL201", "mla_absorbed_decode"),
                     ("RPL201", "no_such_op")}
    monkeypatch.undo()
    backward = dict(ops.BACKWARD)
    backward["orphan_bwd"] = ops.BACKWARD["rmsnorm_bwd"]._replace(
        name="orphan_bwd")
    monkeypatch.setattr(ops, "BACKWARD", backward)
    assert {(f.code, f.site)
            for f in lint.check_registry_completeness().findings} == {
        ("RPL201", "orphan_bwd")}


def test_parity_needs_a_card(monkeypatch):
    """RPL203 has no CPU mode: it raises RPL502 rather than comparing the
    plain version with itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lint.check_parity(ops.SPECS["rmsnorm"]),
                 lambda: lint.verify_registry(),
                 lambda: lint.check_parity(ops.SPECS["rmsnorm"],
                                           device="cpu")):
        with pytest.raises(ReproError, match="RPL502") as ei:
            call()
        assert ei.value.code == "RPL502"


def test_parity_compares_within_each_rows_bound():
    """``_disagreement``, the comparison RPL203 runs on the card: bit
    identity, the bfloat16 step, max-abs and relative bounds, integer
    outputs, NaN and infinity placement."""
    d = inv._disagreement
    x = torch.tensor([1.0, 100.0, float("nan"), float("inf")])
    assert d(ops.FUSED["chees_open"], x, x.clone())[0] is None
    assert d(ops.FUSED["chees_open"], x, x + 1e-6)[0] is not None
    lf = ops.SPECS["leapfrog_halfstep"]
    assert d(lf, x, x + 5e-7)[0] is None and d(lf, x, x + 2e-6)[0]
    leaf = ops.FUSED["nuts_leaf"]  # relative: 1e-6 of the largest entry
    assert d(leaf, x, x + 5e-5)[0] is None and d(leaf, x, x + 2e-4)[0]
    b = torch.tensor([3.0, -0.5]).bfloat16()
    assert d(ops.SPECS["rmsnorm"], b, b * (1 + 2 ** -8))[0] is None
    assert d(ops.SPECS["rmsnorm"], b, b * 1.1)[0] is not None
    i = torch.tensor([1, 2])
    assert d(lf, i, i.clone())[0] is None and d(lf, i, i + 1)[0]
    y = x.clone()
    y[0] = float("nan")
    assert d(lf, x, y)[0] == "NaN at other places"


@pytest.mark.parametrize("row,ap", [("mala_accept", 3), ("chees_accept", 4)])
def test_accept_rows_are_float32_within_their_scale_bound(row, ap):
    """The accept rows' parity inputs are float32, as the main path
    launches them.  The plain version in float64, rounded to float32 (a sum
    in another order), lands beyond the bare 1e-6 bound but within
    expm1(1e-6 x scale) of the float32 one; ten times that bound is
    caught."""
    spec = ops.FUSED[row]
    args, _ = inv._sample_inputs(row, torch.device("cpu"))
    assert {a.dtype for a in args if isinstance(a, torch.Tensor)} == {
        torch.float32}
    scale = float(spec.scale(*args).max())
    bound = math.expm1(spec.tol * scale)
    want = spec.ref(*args)[ap]
    other = spec.ref(*(a.double() if isinstance(a, torch.Tensor) else a
                       for a in args))[ap].float()
    err = float((other - want).abs().max())
    assert spec.tol < err <= bound
    assert inv._disagreement(spec, other, want, scale)[0] is None
    assert inv._disagreement(spec, other, want)[0] is not None
    assert inv._disagreement(spec, want + 10 * bound, want, scale)[0]


def _small_nuts_setup():
    def model(x):
        mu = pc.sample("mu", dist.Normal(0.0, 1.0))
        pc.sample("obs", dist.Normal(mu, 1.0), obs=x)
    x = torch.tensor([0.2, -0.1, 0.4])
    return NUTS(model, device="cpu").setup(torch.Generator().manual_seed(0),
                                           10, model_args=(x,))


def test_kernel_setup_contract():
    setup = _small_nuts_setup()
    result = lint.verify_kernel_setup(setup)
    assert result.ok, f"a real NUTS setup violates its contract:\n{result}"
    for bad, fragment in (
            (setup._replace(num_warmup=torch.tensor(10)), "num_warmup"),
            (setup._replace(adapt_schedule=[(0, 10)]), "adapt_schedule"),
            (setup._replace(sample_fn=None), "sample_fn"),
            (setup._replace(cross_chain=1), "cross_chain"),
            (setup._replace(sample_batch_fn=None), "both or neither"),
            (setup._replace(algo=["NUTS"]), "hashable")):
        r = lint.verify_kernel_setup(bad)
        assert "RPL204" in r.codes() and fragment in str(r), fragment
    r = lint.verify_kernel_setup(setup._replace(cross_chain=True),
                                 state={"z": torch.zeros(3, 2)},
                                 num_chains=4)
    assert "RPL204" in r.codes() and "chain axis" in str(r)
    assert lint.verify_kernel_setup(setup._replace(cross_chain=True),
                                    state={"z": torch.zeros(4, 2)},
                                    num_chains=4).ok


def test_kernel_setup_data_axis_drift_is_caught():
    setup = _small_nuts_setup()
    assert setup.data_axis is None
    r = lint.verify_kernel_setup(setup._replace(data_axis="data"))
    assert "RPL204" in r.codes() and "data_shards" in str(r)
    r = lint.verify_kernel_setup(setup._replace(data_axis=3))
    assert "RPL204" in r.codes() and "axis name" in str(r)

    def pot(z):
        return torch.sum(z * z)
    pot.data_shards = 4
    r = lint.verify_kernel_setup(setup._replace(potential_fn=pot))
    assert "RPL204" in r.codes() and "data_axis is None" in str(r)
    assert lint.verify_kernel_setup(setup._replace(potential_fn=pot,
                                                   data_axis="data")).ok


# ---------------------------------------------------------------------------
# validate= on MCMC and SVI; rng_dependent_metrics
# ---------------------------------------------------------------------------

def _logreg(counter=None):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32))
    y = (x @ torch.ones(3) > 0).float()

    def model(x, y=None):
        if counter is not None:
            counter["n"] += 1
        w = pc.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))
        with pc.plate("data", x.shape[0]):
            pc.sample("obs", dist.Bernoulli(logits=x @ w), obs=y)
    return model, x, y


def test_mcmc_validate_rejects_a_defective_model():
    model, *_ = _dup_site(TORCH)
    mcmc = MCMC(NUTS(model, device="cpu"), num_warmup=5, num_samples=5,
                validate=True)
    with pytest.raises(ValueError, match=r"\[RPL001\]"):
        mcmc.run(0)


def test_mcmc_validate_moves_no_draw_and_lints_once():
    counter = {"n": 0}
    model, x, y = _logreg(counter)
    runs = {}
    for validate in (True, False):
        mcmc = MCMC(NUTS(model, device="cpu"), num_warmup=10,
                    num_samples=10, validate=validate)
        traces = []
        for _ in range(2):
            before = counter["n"]
            mcmc.run(0, x, y=y)
            traces.append(counter["n"] - before)
        runs[validate] = (mcmc.get_samples()["w"], traces)
    (w_val, (cold, warm)), (w_plain, (plain, plain2)) = runs[True], \
        runs[False]
    assert torch.equal(w_val, w_plain) and w_val.shape == (10, 3)
    assert plain == plain2 and cold > plain   # linted on the first run
    assert warm == plain                      # and not again


def test_mcmc_validate_surfaces_warnings():
    def model(y):
        mu = pc.sample("mu", dist.Normal(0.0, 1.0))
        pc.sample("obs", dist.Normal(mu, 1.0), obs=y)
    mcmc = MCMC(NUTS(model, device="cpu"), num_warmup=3, num_samples=3,
                validate=True)
    with pytest.warns(UserWarning, match="RPL010"):
        mcmc.run(0, np.zeros(4))


def test_svi_validate_lints_model_and_guide_in_init():
    model, x, y = _logreg()

    def bad_guide(x, y=None):
        pc.param("loc", torch.zeros(3))
        pc.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))
        pc.sample("w", dist.Normal(torch.zeros(3), 1.0).to_event(1))

    svi = SVI(model, bad_guide, adam(1e-2), Trace_ELBO(), validate=True,
              device="cpu")
    with pytest.raises(ValueError, match=r"\[RPL001\]"):
        svi.init(0, x, y=y)

    def guide(x, y=None):
        loc = pc.param("w_loc", torch.zeros(3))
        scale = pc.param("w_scale", torch.ones(3))
        pc.sample("w", dist.Normal(loc, scale.abs() + 1e-3).to_event(1))

    states = []
    for validate in (True, False):
        svi = SVI(model, guide, adam(1e-2), Trace_ELBO(), validate=validate,
                  device="cpu")
        state = svi.init(0, x, y=y)
        state, loss = svi.update(state, x, y=y)
        states.append((state.params["w_loc"], loss))
    assert torch.equal(states[0][0], states[1][0])
    assert torch.equal(states[0][1], states[1][1])


def test_rng_dependent_metrics():
    from repro_torch.core.infer import chees_setup, hmc_setup, mrw_setup
    model, x, y = _logreg()
    common = dict(model=model, model_args=(x,), model_kwargs={"y": y},
                  device="cpu")
    setups = [hmc_setup(None, 10, algo="NUTS", **common),
              hmc_setup(None, 10, algo="NUTS", cross_chain_adapt=True,
                        **common),
              chees_setup(None, 10, **common),
              mrw_setup(None, 10, "MALA", **common)]
    for setup in setups:
        assert lint.rng_dependent_metrics(setup, num_chains=4) == []
    bad = setups[0]._replace(metrics_fn=lambda st: {
        "noise": torch.rand(()), "step_size": st.adapt_state.step_size})
    assert lint.rng_dependent_metrics(bad, num_chains=4) == ["noise"]


# ---------------------------------------------------------------------------
# mla_absorbed_decode: the plain version of the ref-only row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_the_reference(dtype):
    """Against ``repro.kernels.ref.mla_absorbed_decode`` on the same inputs
    with a mask that drops positions: float32 within 1e-5 (einsum order),
    bfloat16 within one bfloat16 step of the reference's (both compute in
    float32 and round once)."""
    rng = np.random.default_rng(3)
    B, S, H, dn, dr, r, dv = 2, 9, 4, 16, 8, 12, 16
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, 1, H, dn), (B, 1, H, dr), (B, S, r), (B, S, dr), (H, dn, r),
        (H, r, dv))]
    mask = np.ones((B, S), bool)
    mask[0, 5:] = False
    mask[1, :2] = False
    scale = (dn + dr) ** -0.5
    want = np.asarray(jref.mla_absorbed_decode(
        *[jnp.asarray(a, dtype) for a in arrays], jnp.asarray(mask),
        scale=scale).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = ops.mla_absorbed_decode(
        *[torch.from_numpy(a).to(tdt) for a in arrays],
        torch.from_numpy(mask), scale=scale)
    assert got.dtype == tdt and got.shape == (B, 1, H, dv)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        bound = ops.BF16_RTOL * np.abs(want) + ops.BF16_ATOL
        assert (np.abs(got - want) <= bound).all()
    assert ops.SPECS["mla_absorbed_decode"].ref \
        is flash.mla_absorbed_decode_ref
