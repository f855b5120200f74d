"""The port's telemetry (``repro_torch.obs``, the samplers' ``metrics_fn``,
RPL401/402) against the JAX package's ``repro.obs``.

- Level 1, the same inputs into both packages: the event schema byte for
  byte and the manifest schema but for a session's ``environment``;
  ``validate.check``'s findings; ``DivergenceRing``'s JSON, ``localize`` and
  report text; ``LiveReporter``'s lines; ``compare``'s exit codes and
  rendered reports, and ``DEFAULT_RULES``.  Equal bits (equal text).
- Each sampler's ``metrics_fn`` on the reference's state after one
  transition (``interop.state_from_reference``): NUTS on one chain, four
  chains batched, cross-chain; ChEES, MALA and RWM.  Leaves equal the
  reference's in float64 within 1e-12, and the port's buffered series have
  the shapes the reference's executor gives them.
- The reference's contracts on the port's executor, on the CPU: telemetry
  on vs off moves no bit of the draws, the collected fields or the final
  state on any path, and adds exactly one host read a chunk (one more for a
  chunk that diverged); events and manifest validate (through the CLI once);
  the manifest appends a session on resume and the divergence counter
  survives (with and without telemetry); telemetry never calls
  ``checkpoint.save``; ``profile_dir`` writes a trace per chunk span;
  RPL401/402 fire on the reference tests' bad cases and the executor
  rejects them before the first transition; ``sequential`` rejects
  telemetry.

The reference's ChEES and MALA need ``repro._compat``'s jax 0.9.0 patch in
this process (as tests/test_torch_ensemble.py).
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro._compat
import repro.core as jpc
import repro.obs.compare as jcompare
import repro.obs.divergences as jdiv
import repro.obs.report as jreport
import repro.obs.validate as jvalidate
from repro.core import dist as jdist
from repro.core.infer import chees_setup as j_chees_setup
from repro.core.infer import hmc_setup as j_hmc_setup
from repro.core.infer import mrw_setup as j_mrw_setup
import repro_torch.core as pc
import repro_torch.obs.compare as compare
import repro_torch.obs.divergences as divergences
import repro_torch.obs.report as report
import repro_torch.obs.validate as validate
from repro_torch import obs
from repro_torch.core import dist
from repro_torch.core.infer import (HMC, MCMC, NUTS, RWM, ChEES, MALA,
                                    chees_setup, hmc_setup, mrw_setup)
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.interop import state_from_reference
from repro_torch.lint_rules.obs_rules import verify_metrics_fn
from repro_torch.obs.manifest import RunManifest
from repro_torch.obs.sinks import _jsonable

WARMUP, SAMPLES, EVERY, SEED = 24, 36, 20, 11


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors are tiny: torch's thread pool only adds overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(autouse=True)
def _reference_on_jax_0_9(monkeypatch):
    monkeypatch.setattr(repro._compat,
                        "ensure_optimization_barrier_batch_rule",
                        lambda: None)


# ---------------------------------------------------------------------------
# level 1: schemas, validator, forensics, reporter, compare
# ---------------------------------------------------------------------------

def _schema(module, name):
    return os.path.join(os.path.dirname(module.__file__), name)


def test_event_schema_is_the_references_byte_for_byte():
    with open(_schema(validate, "event_schema.json"), "rb") as f, \
            open(_schema(jvalidate, "event_schema.json"), "rb") as g:
        assert f.read() == g.read()


def test_manifest_schema_differs_only_in_the_environment_block():
    with open(validate.MANIFEST_SCHEMA_PATH) as f:
        ours = json.load(f)
    with open(jvalidate.MANIFEST_SCHEMA_PATH) as f:
        ref = json.load(f)
    session, jsession = (s["properties"]["sessions"]["items"]
                         for s in (ours, ref))
    env = session["properties"].pop("environment")
    jsession["properties"].pop("environment")
    assert ours == ref
    assert env["required"] == ["torch_version", "backend", "device_count"]
    assert {"cuda_version", "device_kind", "power_limit_w"} \
        <= set(env["properties"])


def _instances():
    good_manifest = {
        "schema_version": 1, "created_unix": 1.0, "divergences": 0,
        "run": {"algo": "NUTS", "kernel_setup_hash": "ab", "num_warmup": 1,
                "num_samples": 1, "num_chains": 1,
                "chain_method": "vectorized"},
        "sessions": [{"started_unix": 1.0, "resume": False,
                      "resumed_at_iteration": None,
                      "environment": {"jax_version": "x", "backend": "cpu",
                                      "device_count": 1,
                                      "torch_version": "y"},
                      "chunk_schedule": [[0, 1, "warmup"]], "spans": [],
                      "counters": {}, "final": None}]}
    bad_manifest = copy.deepcopy(good_manifest)
    del bad_manifest["sessions"][0]["spans"]
    bad_manifest["run"]["num_chains"] = "4"
    return [
        ("event", {"kind": "span", "t_unix": 0}),
        ("event", {"kind": "span", "t_unix": 0, "span": "x",
                   "start_unix": 1, "duration_s": 0.5}),
        ("event", {"kind": "chunk", "t_unix": 1.5, "phase": "tune",
                   "start": 0.5, "end": 3}),
        ("event", {"kind": "bogus"}),
        ("event", {"kind": "run_finished", "t_unix": 0, "done": True,
                   "divergences": 0}),
        ("event", ["not", "an", "object"]),
        ("manifest", good_manifest),
        ("manifest", bad_manifest),
    ]


@pytest.mark.parametrize("i", range(len(_instances())))
def test_validate_check_findings_match_reference(i):
    kind, instance = _instances()[i]
    path = validate.EVENT_SCHEMA_PATH if kind == "event" \
        else validate.MANIFEST_SCHEMA_PATH
    jpath = jvalidate.EVENT_SCHEMA_PATH if kind == "event" \
        else jvalidate.MANIFEST_SCHEMA_PATH
    with open(path) as f, open(jpath) as g:
        schema, jschema = json.load(f), json.load(g)
    ours = validate.check(instance, schema)
    ref = jvalidate.check(instance, jschema)
    if kind == "manifest":
        # the environment block is the one place the schemas differ
        ref = [e.replace("jax_version", "torch_version") for e in ref]
        ours = [e for e in ours if "torch_version" not in e] + [
            e for e in ref if "torch_version" in e]
    assert ours == ref


def test_jsonable_takes_tensors_and_numpy_scalars():
    tree = {"t0": torch.tensor(1.5), "t1": torch.arange(3),
            "b": torch.tensor(True), "f32": np.float32(0.25),
            "i64": np.int64(7), "arr": np.arange(2.0), "nested": [
                np.bool_(False), (torch.tensor(2),)], "big": torch.zeros(5000)}
    out = _jsonable(tree)
    json.dumps(out)
    assert out["t0"] == 1.5 and out["t1"] == [0, 1, 2] and out["b"] is True
    assert out["f32"] == 0.25 and out["i64"] == 7 and out["arr"] == [0.0, 1.0]
    assert out["nested"] == [False, [2]] and isinstance(out["big"], str)


def _forensics_inputs():
    rng = np.random.default_rng(7)
    c, k, d = 4, 10, 3
    out = {"z": rng.normal(size=(c, k, d)).astype(np.float32),
           "energy": rng.normal(size=(c, k)).astype(np.float32),
           "step_size": np.full((c, k), 0.3, np.float32)}
    mask = rng.random((c, k)) < 0.2
    mask[2, 5] = True
    base = rng.normal(size=(c, 30, d))
    return out, mask, base


@pytest.mark.parametrize("capacity", [256, 3])
def test_divergence_ring_matches_reference(capacity):
    out, mask, base = _forensics_inputs()
    ours, ref = divergences.DivergenceRing(capacity), \
        jdiv.DivergenceRing(capacity)
    for start in (24, 34):
        assert ours.fold(start, out, mask) == ref.fold(start, out, mask)
    # the card's path: the same rows gathered from tensors, one read
    device = divergences.DivergenceRing(capacity)
    for start in (24, 34):
        device.fold(start, {k: torch.from_numpy(v) for k, v in out.items()},
                    mask)
    for ring in (ours, ref, device):
        ring.set_baseline(base)
    assert json.dumps(ours.to_json()) == json.dumps(ref.to_json())
    assert json.dumps(device.to_json()) == json.dumps(ref.to_json())
    data = ours.to_json()
    assert divergences.localize(data) == jdiv.localize(ref.to_json())
    assert divergences.report(data, top=2) == jdiv.report(ref.to_json(),
                                                          top=2)
    empty = divergences.DivergenceRing().to_json()
    assert divergences.report(empty) == jdiv.report(
        jdiv.DivergenceRing().to_json())
    del data["baseline"]
    assert divergences.report(data) == jdiv.report(data)


def test_divergences_cli_matches_reference(tmp_path, capsys):
    out, mask, base = _forensics_inputs()
    ring = divergences.DivergenceRing()
    ring.fold(24, out, mask)
    ring.set_baseline(base)
    ring.write(str(tmp_path))
    assert divergences.main([str(tmp_path), "--top", "2"]) == 0
    ours = capsys.readouterr().out
    assert jdiv.main([str(tmp_path), "--top", "2"]) == 0
    assert ours == capsys.readouterr().out
    assert divergences.main([str(tmp_path / "missing")]) == 2


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        self.t += 7.5
        return self.t


def test_live_reporter_lines_match_reference(monkeypatch):
    monkeypatch.setattr(report, "time", _Clock())
    monkeypatch.setattr(jreport, "time", _Clock())
    lines, jlines = [], []
    ours, ref = report.LiveReporter(lines.append), \
        jreport.LiveReporter(jlines.append)
    rng = np.random.default_rng(0)
    chunks = [
        dict(done=40, total=1200, phase="warmup", num_chains=4,
             divergences=0),
        dict(done=80, total=1200, phase="sample", num_chains=4,
             divergences=3, delta_div=3,
             metrics={"step_size": np.full((4, 40), 0.5),
                      "accept_prob": rng.random((4, 40))}),
        dict(done=600, total=1200, phase="sample", num_chains=4,
             divergences=3, delta_div=0,
             metrics={"step_size": rng.random(40),
                      "accept_prob": rng.random((4, 40))},
             convergence={"max_rhat": 1.0123, "min_ess": float("nan")}),
        dict(done=1200, total=1200, phase="sample", num_chains=4,
             divergences=9, delta_div=6, metrics={},
             convergence={"max_rhat": float("nan"), "min_ess": 410.6}),
    ]
    for rep in (ours, ref):
        rep.start(1200)
    for kw in chunks:
        assert ours.chunk(**kw) == ref.chunk(**kw)
    assert lines == jlines and len(lines) == 4
    assert "eta:" in lines[1] and "rhat: 1.012" in lines[2]
    assert report._fmt_eta(7300) == jreport._fmt_eta(7300)


BENCH = {"logreg": {"ms_per_leapfrog": 1.0, "min_ess": 100.0,
                    "divergences": 0},
         "hmm": {"ms_per_leapfrog": 2.0},
         "obs_overhead": {"within_budget": True,
                          "monitor_within_budget": True}}


def _compare_cases(tmp_path):
    def write(name, data):
        path = str(tmp_path / name)
        with open(path, "w") as f:
            json.dump(data, f)
        return path

    bad = copy.deepcopy(BENCH)
    bad["logreg"]["ms_per_leapfrog"] = 3.0
    bad["logreg"]["min_ess"] = 10.0
    bad["obs_overhead"]["monitor_within_budget"] = False
    missing = copy.deepcopy(BENCH)
    del missing["hmm"]
    missing["new_metric"] = 1.0
    man = {"divergences": 0, "run": {"num_chains": 4}, "sessions": [
        {"final": {"divergences": 0, "convergence": {"max_rhat": 1.01,
                                                      "min_ess": 300.0}}}]}
    worse = copy.deepcopy(man)
    worse["divergences"] = 3
    worse["sessions"][0]["final"]["convergence"]["min_ess"] = 100.0
    rules = write("rules.json", {"bench": [{"metric": "*.ms_per_leapfrog",
                                            "kind": "rel_increase",
                                            "max": 5.0}]})
    base = write("base.json", BENCH)
    return [
        [write("same.json", BENCH), base],
        [write("bad.json", bad), base, "--report",
         str(tmp_path / "r" / "report.json")],
        [write("missing.json", missing), base],
        [write("bad2.json", bad), base, "--thresholds", rules],
        [write("man_worse.json", worse), write("man.json", man)],
        [str(tmp_path / "man.json"), base],
        [str(tmp_path / "nope.json"), base],
        [base],
    ]


def test_compare_matches_reference(tmp_path, capsys):
    assert compare.DEFAULT_RULES == jcompare.DEFAULT_RULES
    codes = []
    for argv in _compare_cases(tmp_path):
        code = compare.main(list(argv))
        ours = capsys.readouterr()
        assert jcompare.main(list(argv)) == code, argv
        ref = capsys.readouterr()
        assert ours.out == ref.out, argv
        assert ours.err.replace("repro_torch.obs", "repro.obs") == ref.err
        codes.append(code)
    assert codes == [0, 1, 1, 0, 1, 2, 2, 2]
    assert compare.flatten({"a": {"b": 1, "c": True, "d": [1]}}) \
        == jcompare.flatten({"a": {"b": 1, "c": True, "d": [1]}})


# ---------------------------------------------------------------------------
# the samplers' metrics_fn against the reference's
# ---------------------------------------------------------------------------

def _logreg_data():
    """The reference tests' logreg geometry (80 x 3, y = [x @ 1 > 0]), drawn
    with numpy."""
    x = np.random.default_rng(0).standard_normal((80, 3)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.float32)


def j_logreg(x, y=None):
    m = jpc.sample("m", jdist.Normal(0.0, jnp.ones(3)).to_event(1))
    b = jpc.sample("b", jdist.Normal(0.0, 1.0))
    return jpc.sample("y", jdist.Bernoulli(logits=x @ m + b), obs=y)


def logreg(x, y=None):
    m = pc.sample("m", dist.Normal(0.0, torch.ones(3)).to_event(1))
    b = pc.sample("b", dist.Normal(0.0, 1.0))
    return pc.sample("y", dist.Bernoulli(logits=x @ m + b), obs=y)


CHAINS = 4


@pytest.fixture(scope="module")
def reference_states():
    """Each case: the reference's setup, a state after one transition
    (host numpy), and the reference's metrics on that state.  The chains
    start at one fixed point and NUTS and ChEES at the default step size
    (no initial-point or step-size search: they only cost compile time
    here, and the metrics read whatever the state holds); the transition
    moves each chain its own way."""
    patched = repro._compat.ensure_optimization_barrier_batch_rule
    repro._compat.ensure_optimization_barrier_batch_rule = lambda: None
    try:
        return _reference_cases()
    finally:
        repro._compat.ensure_optimization_barrier_batch_rule = patched


def _reference_cases():
    x, y = _logreg_data()
    common = dict(model=j_logreg, model_args=(x,), model_kwargs={"y": y},
                  adapt_step_size=False, init_params={
                      "m": np.full(3, 0.1, np.float32),
                      "b": np.float32(-0.1)})
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(jax.random.PRNGKey(3), CHAINS)
    nuts = j_hmc_setup(key, 10, algo="NUTS", **common)
    init, step = jax.jit(nuts.init_fn), jax.jit(nuts.sample_fn)
    one = [jax.device_get(step(init(k))) for k in keys]
    stacked = jax.tree_util.tree_map(lambda *v: np.stack(v), *one)
    cases = {"NUTS1": (nuts, one[0], jax.jit(nuts.metrics_fn)(one[0])),
             "NUTS4": (nuts, stacked,
                       jax.jit(jax.vmap(nuts.metrics_fn))(stacked))}
    # the cross-chain setup's metrics_fn (the reference vmaps the per-chain
    # one) on the batched state of one transition: a window end, where the
    # two transitions differ, is still far
    cc = j_hmc_setup(key, 10, algo="NUTS", cross_chain_adapt=True, **common)
    cases["cross_chain"] = (cc, stacked, jax.jit(cc.metrics_fn)(stacked))
    for name, setup in (
            ("ChEES", j_chees_setup(key, 10, **common)),
            ("MALA", j_mrw_setup(key, 10, "MALA", **dict(
                common, adapt_step_size=True)))):
        state = jax.device_get(jax.jit(setup.sample_fn)(
            jax.jit(setup.init_fn)(keys)))
        cases[name] = (setup, state, jax.jit(setup.metrics_fn)(state))
    # RWM's metrics_fn is MALA's (the same state type) in both packages:
    # it is read on MALA's state, saving a compile
    rwm = j_mrw_setup(key, 10, "RWM", **dict(common, adapt_step_size=True))
    state = cases["MALA"][1]
    cases["RWM"] = (rwm, state, jax.jit(rwm.metrics_fn)(state))
    return cases


def _port_data():
    return tuple(torch.from_numpy(v) for v in _logreg_data())


def _port_setup(name):
    x, y = _port_data()
    common = dict(model=logreg, model_args=(x,), model_kwargs={"y": y},
                  device="cpu")
    if name in ("NUTS1", "NUTS4"):
        return hmc_setup(None, 10, algo="NUTS", **common)
    if name == "cross_chain":
        return hmc_setup(None, 10, algo="NUTS", cross_chain_adapt=True,
                         **common)
    if name == "ChEES":
        return chees_setup(None, 10, **common)
    return mrw_setup(None, 10, name, **common)


def _as_f64(v):
    if isinstance(v, torch.Tensor):
        return v.double().numpy()
    return np.asarray(v, np.float64)


@pytest.mark.parametrize("name", ["NUTS1", "NUTS4", "cross_chain", "ChEES",
                                  "MALA", "RWM"])
def test_metrics_fn_matches_reference(name, reference_states):
    """The port's metrics_fn on the reference's state after one transition:
    the same leaves within 1e-12 (float64; ChEES's trajectory length within
    one float32 ulp: it is ``exp`` of the float32 log length, and numpy's
    ``exp`` and XLA's differ by an ulp on ~40% of float32 inputs, neither
    correctly rounded), and the port executor's series
    shapes are the reference executor's (per-chain kernels (C, draws) under
    its vmap, cross-chain pooled leaves (draws,) and per-chain (C,
    draws))."""
    jsetup, jstate, jmetrics = reference_states[name]
    setup = _port_setup(name)
    ours = setup.metrics_fn(state_from_reference(jstate, "cpu"))
    assert sorted(ours) == sorted(jmetrics)
    for k, v in jmetrics.items():
        tol = dict(rtol=2.0 ** -23, atol=0) if k == "trajectory_length" \
            else dict(rtol=0, atol=1e-12)
        np.testing.assert_allclose(_as_f64(ours[k]),
                                   np.asarray(v, np.float64), err_msg=k,
                                   **tol)
    chains = 1 if name == "NUTS1" else CHAINS
    draws = 6
    per_chain = name in ("NUTS1", "NUTS4")
    expected = {k: ((chains,) if per_chain else np.shape(v)) + (draws,)
                for k, v in jmetrics.items()}
    kernel = {"NUTS1": NUTS, "NUTS4": NUTS, "cross_chain": NUTS,
              "ChEES": ChEES, "MALA": MALA, "RWM": RWM}[name]
    kw = {"cross_chain_adapt": True} if name == "cross_chain" else {}
    tele = obs.Telemetry()
    x, y = _port_data()
    MCMC(kernel(logreg, device="cpu", **kw), 4, draws, num_chains=chains,
         telemetry=tele).run(0, x, y=y)
    assert {k: v.shape for k, v in tele.buffer.series().items()} == expected
    assert {k: v.shape[:-1] + (4,) for k, v in
            tele.buffer.series("warmup").items()} \
        == {k: v[:-1] + (4,) for k, v in expected.items()}


# ---------------------------------------------------------------------------
# the executor's contracts
# ---------------------------------------------------------------------------

def model():
    pc.sample("x", dist.Normal(1.0, 2.0))


def funnel():
    v = pc.sample("v", dist.Normal(0.0, 3.0))
    pc.sample("x", dist.Normal(0.0, torch.exp(0.5 * v)))


KERNELS = {
    "NUTS1": (lambda m: NUTS(m, device="cpu"), 1),
    "NUTS4": (lambda m: NUTS(m, device="cpu"), 4),
    "HMC2": (lambda m: HMC(m, device="cpu"), 2),
    "cross_chain": (lambda m: NUTS(m, cross_chain_adapt=True,
                                   device="cpu"), 4),
    "ChEES": (lambda m: ChEES(m, device="cpu"), 4),
    "MALA": (lambda m: MALA(m, device="cpu"), 4),
    "RWM": (lambda m: RWM(m, device="cpu"), 4),
}


def _mcmc(name, m=model, **kw):
    make, chains = KERNELS[name]
    return MCMC(make(m), WARMUP, SAMPLES, num_chains=chains, **kw)


def _leaves(tree, path=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}/{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_same(a, b, what):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert list(la) == list(lb), what
    for key, x in la.items():
        y = lb[key]
        assert type(x) is type(y), (what, key)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (what, key)
        elif isinstance(x, (np.ndarray, np.generic)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, key)
        else:
            assert x == y, (what, key)


# ChEES runs the funnel, which diverges under it (forensics' extra read);
# the others the normal model; NUTS4 also writes checkpoints
DIVERGENT = ("ChEES",)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_telemetry_moves_no_bit_and_adds_one_read_a_chunk(name, tmp_path):
    """In chunks of 20: draws, collected fields and final state
    bit-identical with telemetry and progress on vs off, the events valid;
    host reads one
    more a chunk, and one more a sampling chunk that diverged
    (forensics)."""
    m = funnel if name in DIVERGENT else model
    ckdir = (lambda d: str(tmp_path / d)) if name == "NUTS4" \
        else (lambda d: None)
    off = _mcmc(name, m).run(SEED, checkpoint_every=EVERY,
                             checkpoint_dir=ckdir("off"))
    tele = obs.Telemetry(sink=obs.MemorySink(),
                         reporter=obs.LiveReporter(lambda line: None))
    on = _mcmc(name, m, telemetry=tele, progress=True).run(
        SEED, checkpoint_every=EVERY, checkpoint_dir=ckdir("on"))
    _assert_same(on._collected, off._collected, "collected")
    _assert_same(on.last_state, off.last_state, "last state")
    chunks = len([s for s in tele.spans if s.name.endswith("_chunk")])
    assert chunks == 4
    divergent_chunks = len({r["iteration"] >= WARMUP + EVERY
                            for r in tele.forensics.records})
    assert divergent_chunks > 0 or name not in DIVERGENT
    assert on.stats["host_syncs"] - off.stats["host_syncs"] \
        == chunks + divergent_chunks
    assert on._divergences == int(off._collected["diverging"].sum()) \
        == tele.forensics.total
    assert not any(s.attr("program_cold") for s in tele.spans
                   if s.name.endswith("_chunk"))
    assert tele.counters == {"kernel_builds": 0, "graph_captures": 0}
    with open(validate.EVENT_SCHEMA_PATH) as f:
        schema = json.load(f)
    events = tele.sink.events
    assert all(validate.check(e, schema) == [] for e in events)
    assert [e["kind"] for e in events if e["kind"] != "span"] \
        == ["run_started"] + ["chunk"] * chunks + ["run_finished"]
    assert len(tele.reporter.lines) == chunks


class _Preempted(BaseException):
    """The kill: raised from the save wrapper, caught nowhere else."""


def _run_saves(mcmc, ckdir, kill_at=None, resume=False):
    real_save, calls = ckpt.save, {"n": 0}

    def wrapped(tree, directory, **kw):
        real_save(tree, directory, **kw)
        calls["n"] += 1
        if calls["n"] == kill_at:
            raise _Preempted(f"preempted after save #{kill_at}")

    ckpt.save = wrapped
    try:
        mcmc.run(SEED, checkpoint_every=EVERY, checkpoint_dir=ckdir,
                 resume=resume)
    except _Preempted:
        pass
    finally:
        ckpt.save = real_save
    return calls["n"]


@pytest.fixture(scope="module")
def funnel_reference(tmp_path_factory):
    """The uninterrupted checkpointed funnel run (ChEES, which diverges
    there)."""
    ref = _mcmc("ChEES", funnel)
    assert _run_saves(ref, str(tmp_path_factory.mktemp("ref"))) == 6
    assert ref._divergences > 0, "the funnel run did not diverge"
    return ref


@pytest.mark.parametrize("with_telemetry", [True, False])
def test_manifest_appends_on_resume_and_divergences_survive(
        tmp_path, with_telemetry, funnel_reference):
    ref = funnel_reference

    def make():
        return _mcmc("ChEES", funnel, telemetry=obs.Telemetry()
                     if with_telemetry else None)

    ckdir = str(tmp_path / "kill")
    assert _run_saves(make(), ckdir, kill_at=3) == 3
    resumed = make()
    _run_saves(resumed, ckdir, resume=True)
    assert torch.equal(resumed._collected["z"], ref._collected["z"])
    assert resumed._divergences == ref._divergences
    path = os.path.join(ckdir, obs.MANIFEST_NAME)
    if not with_telemetry:
        assert not os.path.exists(path)
        return
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate",
         os.path.join(ckdir, "events.jsonl"), path],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    bad = os.path.join(ckdir, "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"kind": "span", "t_unix": 0}\n')
    assert validate.main([bad]) == 1
    man = RunManifest.peek(path).data
    first, second = man["sessions"]
    assert first["resume"] is False and first["final"] is None
    assert second["resume"] is True
    assert second["resumed_at_iteration"] == WARMUP
    assert second["final"]["divergences"] == ref._divergences
    assert man["divergences"] == ref._divergences
    assert [s["span"] for s in second["spans"]][:2] == ["setup",
                                                        "resume_restore"]
    environment = second["environment"]
    assert environment["torch_version"] == torch.__version__
    assert environment["backend"] == "cpu"
    final = second["final"]
    assert final["done"] == WARMUP + SAMPLES
    assert set(final["metrics"]) == {
        "step_size", "trajectory_length", "num_steps", "mass_trace",
        "accept_prob", "diverging", "energy"}
    forensics = divergences.load(ckdir)
    assert forensics["total"] == ref._divergences
    assert forensics["baseline"]["draws"] == CHAINS * SAMPLES


def test_telemetry_never_calls_checkpoint_save(tmp_path):
    tele = obs.Telemetry(dir=str(tmp_path / "artifacts"))
    assert _run_saves(_mcmc("ChEES", funnel, telemetry=tele),
                      str(tmp_path / "ck")) == 6


def test_profile_dir_writes_a_trace_per_chunk_span(tmp_path):
    prof = tmp_path / "prof"
    tele = obs.Telemetry(profile_dir=str(prof))
    MCMC(NUTS(model, device="cpu"), 2, 4, num_chains=2,
         telemetry=tele).run(0, checkpoint_every=2)
    traces = sorted(p.name for p in prof.iterdir())
    assert traces == ["0001_warmup_chunk", "0002_sample_chunk",
                      "0003_sample_chunk"]
    for t in traces:
        with open(prof / t / "trace.json") as f:
            assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# RPL401 / RPL402 and the executor's check
# ---------------------------------------------------------------------------

def _nuts_setup():
    x, y = _port_data()
    return hmc_setup(None, 10, algo="NUTS", model=logreg, model_args=(x,),
                     model_kwargs={"y": y}, device="cpu")


def test_builtin_metrics_fns_pass_the_contract():
    for name in ("NUTS1", "cross_chain", "ChEES", "MALA", "RWM"):
        setup = _port_setup(name)
        assert setup.metrics_fn is not None
        assert verify_metrics_fn(setup, num_chains=4).ok, name


def test_rpl401_fires_on_non_scalar_metric_leaf():
    bad = _nuts_setup()._replace(metrics_fn=lambda st: {"z": st.z})
    result = verify_metrics_fn(bad, num_chains=4)
    assert [(f.code, f.site) for f in result.findings] == [("RPL401", "z")]
    with pytest.raises(Exception, match="RPL401"):
        result.raise_if_errors()


def test_rpl402_fires_on_a_metric_that_draws():
    bad = _nuts_setup()._replace(metrics_fn=lambda st: {
        "noise": torch.rand(st.z.shape[:-1]),
        "step_size": st.adapt_state.step_size})
    state = torch.get_rng_state()
    result = verify_metrics_fn(bad, num_chains=4)
    assert [(f.code, f.site) for f in result.findings] \
        == [("RPL402", "noise")]
    assert torch.equal(torch.get_rng_state(), state), \
        "the check left the global generator moved"


@pytest.mark.parametrize("bad", ["RPL401", "RPL402"])
def test_executor_rejects_a_bad_metrics_fn_before_the_first_transition(bad):
    fn = {"RPL401": lambda st: {"z": st.z},
          "RPL402": lambda st: {"noise": torch.randn(())}}[bad]
    kernel = NUTS(model, device="cpu")
    real_setup, steps = kernel.setup, []

    def setup(*args, **kwargs):
        s = real_setup(*args, **kwargs)

        def sample_batch_fn(state, draws):
            steps.append(1)
            return s.sample_batch_fn(state, draws)

        sample_batch_fn.lockstep = s.sample_batch_fn.lockstep
        return s._replace(metrics_fn=fn, sample_batch_fn=sample_batch_fn)

    kernel.setup = setup
    mcmc = MCMC(kernel, 10, 10, num_chains=2, telemetry=obs.Telemetry())
    with pytest.raises(Exception, match=bad):
        mcmc.run(0)
    assert not steps


def test_sequential_chain_method_rejects_telemetry():
    mcmc = MCMC(NUTS(model, device="cpu"), 10, 10, num_chains=2,
                chain_method="sequential", telemetry=obs.Telemetry())
    with pytest.raises(ValueError, match="batched chain_method"):
        mcmc.run(0)
