"""Kill and resume on the port's chunked executor, on the CPU: the JAX
package's preemption sweep (tests/test_preemption.py:131, :164) and
chunking contract (tests/test_mcmc.py:176) for every sampler path.

The chunking (num_warmup=24, num_samples=36, checkpoint_every=20) makes a
run perform exactly six ``checkpoint.save`` calls:

    1. state @ 20                (warmup chunk)
    2. state @ 24                (warmup remainder)
    3. samples_000024_000044     (first sampling chunk, samples write)
    4. state @ 44                (first sampling chunk, state write)
    5. samples_000044_000060     (second sampling chunk, samples write)
    6. state @ 60                (final state write)

A kill is a private ``BaseException`` raised right after a save call.
Every comparison is exact: draws, extra fields, final states and the draw
sources' generator states bit for bit (``torch.equal``,
``np.array_equal``), host scalars of the same Python and numpy type.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro_torch.core as pc
from repro_torch.core import dist
from repro_torch.core.infer import HMC, MCMC, NUTS, RWM, ChEES, MALA
from repro_torch.distributed import checkpoint as ckpt

WARMUP, SAMPLES, EVERY, SAVES, SEED = 24, 36, 20, 6, 11


class _Preempted(BaseException):
    """The kill: raised from the save wrapper, caught nowhere else."""


def model():
    pc.sample("x", dist.Normal(1.0, 2.0))


KERNELS = {
    "NUTS1": (lambda: NUTS(model, device="cpu"), 1),
    "NUTS4": (lambda: NUTS(model, device="cpu"), 4),
    "HMC2": (lambda: HMC(model, device="cpu"), 2),
    "ChEES": (lambda: ChEES(model, device="cpu"), 4),
    "MALA": (lambda: MALA(model, device="cpu"), 4),
    "RWM": (lambda: RWM(model, device="cpu"), 4),
    "cross_chain": (lambda: NUTS(model, cross_chain_adapt=True,
                                 device="cpu"), 4),
    "dense": (lambda: NUTS(model, dense_mass=True, device="cpu"), 2),
}


def _mcmc(name, **kw):
    make, chains = KERNELS[name]
    return MCMC(make(), kw.pop("num_warmup", WARMUP),
                kw.pop("num_samples", SAMPLES), num_chains=chains, **kw)


def _run(name, ckdir=None, kill_at=None, resume=False, every=EVERY, **kw):
    """Run with checkpointing; with ``kill_at``, preempt right after that
    save call.  Returns ``(mcmc or None, save calls made)``."""
    real_save, calls = ckpt.save, {"n": 0}

    def wrapped(tree, directory, **kwargs):
        real_save(tree, directory, **kwargs)
        calls["n"] += 1
        if calls["n"] == kill_at:
            raise _Preempted(f"preempted after save #{kill_at}")

    ckpt.save = wrapped
    mcmc = _mcmc(name, **kw)
    try:
        mcmc.run(SEED, checkpoint_every=every,
                 checkpoint_dir=ckdir, resume=resume)
    except _Preempted:
        return None, calls["n"]
    finally:
        ckpt.save = real_save
    return mcmc, calls["n"]


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
        assert type(x) is type(y), (what, key, type(x), type(y))
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, (what, key)
            assert torch.equal(x, y), (what, key)
        elif isinstance(x, (np.ndarray, np.generic)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, key)
        else:
            assert x == y, (what, key)


def _assert_same_run(got, want, what):
    _assert_same(got._collected, want._collected, f"{what}: draws")
    _assert_same(got.get_samples(group_by_chain=True),
                 want.get_samples(group_by_chain=True), f"{what}: samples")
    _assert_same(got.last_state, want.last_state, f"{what}: last state")


def _generator_states(ckdir):
    """The draw sources' saved generator states (uint8 tensors)."""
    with open(os.path.join(ckdir, "state", "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return [np.load(os.path.join(ckdir, "state", m["file"]))
            for k, m in leaves.items() if k.startswith("draws/")]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Each sampler's run without a checkpoint, and with one (whose final
    generator states the resumed runs must reach)."""
    cache = {}

    def get(name):
        if name not in cache:
            plain, _ = _run(name, every=None)
            ckdir = str(tmp_path_factory.mktemp(name) / "ck")
            checked, saves = _run(name, ckdir)
            assert saves == SAVES, (
                f"checkpoint chunking changed: expected {SAVES} save calls, "
                f"got {saves}")
            _assert_same_run(checked, plain, f"{name}: checkpointed")
            cache[name] = (plain, checked, _generator_states(ckdir))
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["NUTS1", "NUTS4", "ChEES", "MALA"])
def test_preemption_sweep_resumes_bit_identical(name, tmp_path,
                                                uninterrupted):
    """Kill after every save call, resume: the draws, the extra fields, the
    final state and the generators' final states are the uninterrupted
    run's."""
    plain, checked, generators = uninterrupted(name)
    for kill_at in range(1, SAVES + 1):
        ckdir = str(tmp_path / f"kill{kill_at}")
        _, made = _run(name, ckdir, kill_at=kill_at)
        assert made == kill_at
        resumed, _ = _run(name, ckdir, resume=True)
        what = f"{name}: resume after kill at save #{kill_at}"
        _assert_same_run(resumed, plain, what)
        assert ckpt.latest_step(os.path.join(ckdir, "state")) \
            == WARMUP + SAMPLES
        assert resumed.stats["resumed_at"] == \
            [20, 24, 24, 44, 44, 60][kill_at - 1]
        assert resumed._divergences == checked._divergences
        for got, want in zip(_generator_states(ckdir), generators):
            assert np.array_equal(got, want), what


@pytest.mark.parametrize("name", ["NUTS1", "RWM", "cross_chain", "dense",
                                  "HMC2"])
def test_kill_mid_sampling_resumes_bit_identical(name, tmp_path,
                                                 uninterrupted):
    """One kill point (after the first sampling chunk's state write) for
    the other paths."""
    plain, _, _ = uninterrupted(name)
    ckdir = str(tmp_path / "ck")
    _run(name, ckdir, kill_at=4)
    resumed, _ = _run(name, ckdir, resume=True)
    _assert_same_run(resumed, plain, name)
    assert resumed.stats["num_iterations"] == WARMUP + SAMPLES - 44


def test_kill_between_samples_and_state_write_rewrites_orphan(tmp_path):
    """tests/test_preemption.py:164 on the port: the kill lands after
    ``samples_000024_000044`` is written and before the state passes 24;
    the resume removes the orphan, writes it again from the same draws and
    finishes bit-identically."""
    plain, _ = _run("NUTS4", every=None)
    ckdir = str(tmp_path / "orphan")
    _run("NUTS4", ckdir, kill_at=3)
    assert ckpt.latest_step(os.path.join(ckdir, "state")) == WARMUP
    orphan = os.path.join(ckdir, "samples_000024_000044")
    assert os.path.isdir(orphan)
    stamp = os.stat(os.path.join(orphan, "manifest.json")).st_mtime_ns
    resumed, saves = _run("NUTS4", ckdir, resume=True)
    assert saves == 4
    assert os.stat(os.path.join(orphan, "manifest.json")).st_mtime_ns \
        != stamp
    _assert_same_run(resumed, plain, "orphan")


@pytest.mark.parametrize("name", ["NUTS1", "HMC2", "ChEES", "MALA", "RWM"])
def test_chunked_executor_matches_single_chunk_bitwise(name):
    """tests/test_mcmc.py:176 on the port: ``checkpoint_every`` moves the
    chunk boundaries, never a bit."""
    whole, _ = _run(name, every=None, num_warmup=40, num_samples=50)
    chunked, saves = _run(name, every=17, num_warmup=40, num_samples=50)
    assert saves == 0
    _assert_same_run(chunked, whole, f"{name}: checkpoint_every=17")


def test_resume_with_another_checkpoint_every(tmp_path):
    """A resume with another ``checkpoint_every`` drops the orphaned
    chunks and still gives the uninterrupted draws."""
    plain, _ = _run("NUTS4", every=None)
    ckdir = str(tmp_path / "ck")
    _run("NUTS4", ckdir, kill_at=5)
    resumed, _ = _run("NUTS4", ckdir, resume=True, every=7)
    _assert_same_run(resumed, plain, "checkpoint_every 20 then 7")
    assert "samples_000044_000060" not in os.listdir(ckdir)


def test_resume_restores_host_scalar_types(tmp_path, uninterrupted):
    """Killed after the last write, a resume runs no transition: its final
    state is the restored one, every host scalar of the uninterrupted
    state's Python and numpy type (float32 stays ``np.float32``)."""
    for name in ("NUTS1", "NUTS4", "ChEES", "MALA"):
        plain, _, _ = uninterrupted(name)
        ckdir = str(tmp_path / name)
        _run(name, ckdir, kill_at=SAVES)
        resumed, _ = _run(name, ckdir, resume=True)
        assert resumed.stats["num_iterations"] == 0
        assert resumed.stats["resumed_at"] == WARMUP + SAMPLES
        state = resumed.last_state
        state = state[0] if isinstance(state, list) else state
        kinds = {type(v) for _, v in _leaves(state)}
        assert kinds <= {torch.Tensor, np.ndarray, np.float32, int, bool}
        _assert_same(resumed.last_state, plain.last_state, name)


def test_divergence_counter_continues_across_a_resume(tmp_path,
                                                      uninterrupted):
    """The cumulative divergences (checkpoint extra, ``stats``) continue
    from the restored count, not from 0."""
    plain, checked, _ = uninterrupted("NUTS4")
    total = int(plain.get_extra_fields()["diverging"].sum())
    assert total > 0, "no divergence: the counter is not exercised"
    assert checked._divergences == total
    ckdir = str(tmp_path / "ck")
    _run("NUTS4", ckdir, kill_at=4)
    with open(os.path.join(ckdir, "state", "manifest.json")) as f:
        at_kill = json.load(f)["extra"]["divergences"]
    assert 0 < at_kill < total
    resumed, _ = _run("NUTS4", ckdir, resume=True)
    assert resumed._divergences == total
    with open(os.path.join(ckdir, "state", "manifest.json")) as f:
        assert json.load(f)["extra"]["divergences"] == total
    assert plain._divergences == 0  # no count (no read) without a directory


def test_resumed_run_counts_only_its_own_work(tmp_path, uninterrupted):
    """The restore's skeleton init is not counted: a resume from the end of
    warmup counts the sampling transitions' evaluations alone."""
    plain, _, _ = uninterrupted("NUTS1")
    ckdir = str(tmp_path / "ck")
    _run("NUTS1", ckdir, kill_at=2)
    resumed, _ = _run("NUTS1", ckdir, resume=True)
    stats = resumed.stats
    assert stats["init_grad_evals"] == 0
    assert stats["num_iterations"] == SAMPLES
    steps = int(resumed.get_extra_fields()["num_steps"].sum())
    assert stats["num_leapfrog"] == stats["num_grad_evals"] == steps


def test_checkpoint_errors(tmp_path):
    """The reference executor's errors, its texts."""
    with pytest.raises(ValueError, match="resume=True requires "
                                         "checkpoint_dir"):
        _mcmc("NUTS1").run(SEED, resume=True)
    for kw in ({"checkpoint_dir": str(tmp_path / "x")},
               {"checkpoint_every": 5}):
        with pytest.raises(ValueError, match="checkpointing requires a "
                                             "batched chain_method"):
            _mcmc("NUTS4", chain_method="sequential").run(SEED, **kw)
    ckdir = str(tmp_path / "ck")
    _run("NUTS4", ckdir)
    for field, kw in (("num_warmup", {"num_warmup": 25}),
                      ("num_samples", {"num_samples": 30})):
        with pytest.raises(ValueError, match=f"written by a run with "
                                             f"{field}="):
            _mcmc("NUTS4", **kw).run(SEED, checkpoint_every=EVERY,
                                     checkpoint_dir=ckdir, resume=True)
    with pytest.raises(ValueError, match="num_chains=4, this MCMC has 1"):
        _mcmc("NUTS1").run(SEED, checkpoint_every=EVERY,
                           checkpoint_dir=ckdir, resume=True)
    last = os.path.join(ckdir, "samples_000044_000060")
    shutil.move(last, str(tmp_path / "moved"))
    with pytest.raises(ValueError, match=r"missing sample chunks covering "
                                         r"iterations 44\.\.60"):
        _run("NUTS4", ckdir, resume=True)
    shutil.move(str(tmp_path / "moved"), last)
    shutil.rmtree(os.path.join(ckdir, "samples_000024_000044"))
    with pytest.raises(ValueError, match="missing the sample chunk starting "
                                         "at iteration 24"):
        _run("NUTS4", ckdir, resume=True)


def test_sequential_one_chain_checkpoints(tmp_path, uninterrupted):
    """One chain under ``"sequential"`` runs the one-chain path, which
    checkpoints and resumes as under ``"vectorized"``."""
    plain, _, _ = uninterrupted("NUTS1")
    ckdir = str(tmp_path / "ck")
    _run("NUTS1", ckdir, kill_at=3, chain_method="sequential")
    resumed, _ = _run("NUTS1", ckdir, resume=True, chain_method="sequential")
    _assert_same_run(resumed, plain, "sequential, one chain")


def test_graph_capture_pauses_the_garbage_collector(monkeypatch):
    """ChEES's trajectory bodies are captured with the collector paused: a
    resumed run captures while the killed run's graphs are garbage, and a
    dead graph freed mid-capture ends the capture with an error (seen on
    the card).  The CUDA calls are stand-ins here; the collector's state is
    read inside the capture, and it comes back on after it, also when the
    capture raises."""
    import contextlib
    import gc
    import types

    from repro_torch.core.infer import graphs

    seen = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, stream=None):
            pass

        def __enter__(self):
            seen.append(gc.isenabled())

        def __exit__(self, *exc):
            return False

    class Potentials:
        def record_stream(self, stream):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    owner = types.SimpleNamespace(
        capture_stream=Stream, counters=list, eager_bodies={"b": 0},
        replays={"b": 0}, capture_seconds=0.0)
    calls = []

    def body():
        calls.append(gc.isenabled())
        return Potentials()

    assert gc.isenabled()
    graphs._GraphedBody("b", body, owner)()
    assert seen == [False] and calls == [True, False] and gc.isenabled()

    def failing():
        if calls:
            raise RuntimeError("capture failed")
        calls.append(True)
        return Potentials()

    calls.clear()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs._GraphedBody("b", failing, owner)()
    assert gc.isenabled()
