"""``chain_method="parallel"`` across four processes on the CPU: the port's
counterpart of the JAX package's multi-device tests
(tests/test_sharded_mesh.py:67 ``test_sample_streams_identical_across_layouts``,
tests/test_elastic.py:174 and tests/test_parallel_chains.py:40-160).

Each sampler's job starts four ranks of this file as a script (``python
tests/test_torch_sharded.py SAMPLER RANK DIR``), joined by gloo through a
``file://`` rendezvous in the test's temporary directory (no TCP port), each
pinned to one thread; the jobs run one after another.  Rank 0 also runs the
one-process ``"vectorized"`` reference.  Every rank writes the SHA-256 of its draws and final state (the
bytes, dtypes and shapes of every leaf) for each run; the tests compare
them exactly.

- ``layouts``: NUTS (lockstep, and with ``cross_chain_adapt``), ChEES and
  MALA with ``data_shards=4`` under the 1-D mesh and the (2, 2), (4, 1)
  and (1, 4) meshes: every rank's draws and state equal the vectorized
  run's.
- ``observed`` (NUTS, ChEES and MALA, in the same jobs): telemetry on
  under (2, 2) (its artifacts in one directory: rank 0 alone writes)
  against the layouts' runs with it off: the draws and state byte for
  byte, the metric series (gathered in rank order on every rank) the
  one-process vectorized run's with telemetry on, one manifest; and a
  NUTS run gated by ``until=`` under (2, 2) equal to the gated
  vectorized run: the same draws, stopping at the same iteration for the
  same reason.
- ``elastic`` (NUTS and MALA, in the same jobs): a (2, 2) run killed
  between a samples write and its state
  write (rank 0 raises right after the samples save, the other ranks at
  the barrier that follows), resumed under (1, 1) and (2, 1) in the four
  ranks and under ``"vectorized"`` in rank 0 alone, and under (2, 2) with
  another ``checkpoint_every``: each equals the uninterrupted run.  A chain
  axis that does not divide the chains raises ``RPL301``, a data axis that
  does not divide ``data_shards`` ``RPL303``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

RANKS = 4
N, D, CHAINS, SHARDS, SEED = 64, 3, 4, 4, 7
WARMUP, SAMPLES, EVERY = 12, 12, 8
LAYOUTS = {"mesh_1d": None, "mesh_2x2": (2, 2), "mesh_4x1": (4, 1),
           "mesh_1x4": (1, 4)}
SAMPLERS = ("nuts", "nuts_cross", "chees", "mala")
OBSERVED = ("nuts", "chees", "mala")
ELASTIC = ("nuts", "mala")
RESUMES = ("mesh_1x1", "mesh_2x1", "vectorized", "mesh_2x2_every5")


# -- the ranks -----------------------------------------------------------------

class _Killed(BaseException):
    """The kill: raised from the save or barrier wrapper."""


def _model():
    import repro_torch.core as pc
    from repro_torch.core import dist

    def model(x, y):
        w = pc.sample("w", dist.Normal(torch.zeros(D), 1.0).to_event(1))
        pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
                  infer={"potential": "glm"})

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    y = torch.from_numpy((rng.random(N) < 0.5).astype(np.float32))
    return model, x, y


def _kernel(name, model):
    from repro_torch.core.infer import MALA, NUTS, ChEES
    make = {"nuts": lambda: NUTS(model, data_shards=SHARDS, device="cpu"),
            "nuts_cross": lambda: NUTS(model, data_shards=SHARDS,
                                       cross_chain_adapt=True, device="cpu"),
            "chees": lambda: ChEES(model, data_shards=SHARDS, device="cpu"),
            "mala": lambda: MALA(model, data_shards=SHARDS, device="cpu")}
    return make[name]()


def _digest(tree, h=None):
    h = h or hashlib.sha256()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            h.update(name.encode())
            _digest(getattr(tree, name), h)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            h.update(str(k).encode())
            _digest(tree[k], h)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _digest(v, h)
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        h.update(f"T{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    elif isinstance(tree, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(tree)
        h.update(f"N{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    else:
        h.update(f"{type(tree).__name__}{tree!r}".encode())
    return h.hexdigest()


def _record(mcmc):
    if mcmc.get_samples() == {}:
        return None  # a rank outside the mesh
    return {"samples": _digest(mcmc.get_samples(group_by_chain=True)),
            "extra": _digest(mcmc.get_extra_fields(group_by_chain=True)),
            "state": _digest(mcmc.last_state)}


def _run(name, chain_method, mesh_shape=None, telemetry=None, **run_kw):
    from repro_torch.core.infer import MCMC
    model, x, y = _model()
    kw = {"mesh_shape": mesh_shape} if mesh_shape is not None else {}
    mcmc = MCMC(_kernel(name, model), WARMUP, SAMPLES, num_chains=CHAINS,
                chain_method=chain_method, telemetry=telemetry, **kw)
    mcmc.run(SEED, x, y, **run_kw)
    return mcmc


def _layouts(name, rank):
    out = {}
    if rank == 0:
        out["vectorized"] = _record(_run(name, "vectorized"))
    for label, shape in LAYOUTS.items():
        out[label] = _record(_run(name, "parallel", shape))
    return out


def _observed(name, rank, workdir):
    """Telemetry on under (2, 2) (and for NUTS a gated run), each against
    the one-process vectorized run with the same options."""
    from repro_torch import obs
    out = {}

    def series(tele):
        return _digest({k: np.asarray(v)
                        for k, v in tele.buffer.series().items()})

    if rank == 0:
        tele = obs.Telemetry()
        _run(name, "vectorized", telemetry=tele)
        out["vectorized_series"] = series(tele)
    artifacts = os.path.join(workdir, f"telemetry_{name}")
    tele = obs.Telemetry(dir=artifacts)
    out["mesh_2x2"] = _record(_run(name, "parallel", (2, 2), telemetry=tele))
    out["mesh_2x2_series"] = series(tele)
    if name == "nuts":
        until = obs.Converged(max_rhat=1.5, min_ess=8.0, check_every=4,
                              batch_size=2)
        if rank == 0:
            mcmc = _run(name, "vectorized", until=until)
            out["gated_vectorized"] = dict(
                _record(mcmc), reason=mcmc.monitor.decision["reason"])
        mcmc = _run(name, "parallel", (2, 2), until=until)
        out["gated_mesh_2x2"] = dict(_record(mcmc),
                                     reason=mcmc.monitor.decision["reason"])
    import torch.distributed as dist
    dist.barrier()
    if rank == 0:
        out["artifacts"] = sorted(os.listdir(artifacts))
        with open(os.path.join(artifacts, "events.jsonl")) as f:
            kinds = [json.loads(line)["kind"] for line in f]
        out["run_started"] = kinds.count("run_started")
    return out


def _killed_run(name, ckdir):
    """The (2, 2) run, killed right after its first samples write."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding
    real_save, real_barrier = ckpt.save, sharding.barrier
    calls = {"save": 0, "barrier": 0}

    def save(tree, directory, **kwargs):
        real_save(tree, directory, **kwargs)
        calls["save"] += 1
        if os.path.basename(directory).startswith("samples_"):
            raise _Killed(f"killed after save #{calls['save']}")

    def barrier(mesh):
        calls["barrier"] += 1
        if calls["barrier"] == 3:  # after the first sampling chunk's writes
            raise _Killed("killed at barrier #3")
        real_barrier(mesh)

    ckpt.save, sharding.barrier = save, barrier
    try:
        _run(name, "parallel", (2, 2), checkpoint_every=EVERY,
             checkpoint_dir=ckdir)
        raise AssertionError("the run was not killed")
    except _Killed:
        pass
    finally:
        ckpt.save, sharding.barrier = real_save, real_barrier


def _error_code(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the code is what is compared
        return getattr(e, "code", None) or f"{type(e).__name__}: {e}"
    return None


def _elastic(name, rank, workdir):
    import torch.distributed as dist
    out = {}
    killed = os.path.join(workdir, f"killed_{name}")
    _killed_run(name, killed)
    copies = {label: os.path.join(workdir, f"{label}_{name}")
              for label in RESUMES}
    if rank == 0:
        assert sorted(os.listdir(killed)) == ["samples_000012_000020",
                                              "state"], os.listdir(killed)
        for path in copies.values():
            shutil.copytree(killed, path)
    dist.barrier()
    resume = dict(resume=True, checkpoint_every=EVERY)
    out["mesh_1x1"] = _record(_run(name, "parallel", (1, 1),
                                   checkpoint_dir=copies["mesh_1x1"],
                                   **resume))
    out["mesh_2x1"] = _record(_run(name, "parallel", (2, 1),
                                   checkpoint_dir=copies["mesh_2x1"],
                                   **resume))
    out["mesh_2x2_every5"] = _record(_run(
        name, "parallel", (2, 2), checkpoint_dir=copies["mesh_2x2_every5"],
        resume=True, checkpoint_every=5))
    if rank == 0:
        out["vectorized"] = _record(_run(name, "vectorized",
                                         checkpoint_dir=copies["vectorized"],
                                         **resume))
        with open(os.path.join(copies["mesh_2x1"], "state",
                               "manifest.json")) as f:
            extra = json.load(f)["extra"]
        out["extra"] = {k: extra[k] for k in ("mesh_shape", "num_devices",
                                              "chain_method")}
    out["rpl301"] = _error_code(lambda: _run(
        name, "parallel", (3, 1), checkpoint_dir=killed, resume=True))
    out["rpl303"] = _error_code(lambda: _run(
        name, "parallel", (1, 3), checkpoint_dir=killed, resume=True))
    return out


def _rank_main(job, rank, workdir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=RANKS)
    out = {"layouts": _layouts(job, rank)}
    if job in OBSERVED:
        out["observed"] = _observed(job, rank, workdir)
    if job in ELASTIC:
        out["elastic"] = _elastic(job, rank, workdir)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# -- the tests -----------------------------------------------------------------

def _spawn(job, workdir):
    """Run ``job`` (a sampler's name) in four ranks; returns each rank's
    results."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, job, str(rank), str(workdir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(RANKS)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} of {job}:\n{log[-4000:]}"
    out = []
    for rank in range(RANKS):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each sampler's ranks' results, spawned at its first use."""
    cache = {}

    def get(sampler):
        if sampler not in cache:
            cache[sampler] = _spawn(sampler,
                                    tmp_path_factory.mktemp(sampler))
        return cache[sampler]

    return get


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_layouts_byte_identical_to_vectorized(results, sampler, layout):
    ranks = [r["layouts"] for r in results(sampler)]
    want = ranks[0]["vectorized"]
    assert want is not None
    for rank, got in enumerate(ranks):
        assert got[layout] == want, f"{sampler} {layout}: rank {rank}"


@pytest.mark.parametrize("sampler", OBSERVED)
def test_telemetry_under_a_four_rank_mesh(results, sampler):
    """Telemetry on under (2, 2): the draws and state byte-identical to
    the runs with it off, every rank's metric series the vectorized
    run's, and one writer's artifacts."""
    ranks = results(sampler)
    want = ranks[0]["layouts"]["vectorized"]
    series = ranks[0]["observed"]["vectorized_series"]
    for rank, r in enumerate(ranks):
        assert r["observed"]["mesh_2x2"] == want, f"{sampler}: rank {rank}"
        assert r["observed"]["mesh_2x2_series"] == series, \
            f"{sampler}: rank {rank}'s metric series"
    seen = ranks[0]["observed"]
    assert seen["artifacts"].count("run_manifest.json") == 1
    assert "events.jsonl" in seen["artifacts"]
    assert seen["run_started"] == 1


def test_gated_run_under_a_four_rank_mesh(results):
    """``until=`` under (2, 2): every rank stops where the gated
    vectorized run stops, with its draws and state."""
    ranks = results("nuts")
    want = ranks[0]["observed"]["gated_vectorized"]
    for rank, r in enumerate(ranks):
        assert r["observed"]["gated_mesh_2x2"] == want, f"rank {rank}"


@pytest.mark.parametrize("resumed", RESUMES)
@pytest.mark.parametrize("sampler", ELASTIC)
def test_elastic_resume_byte_identical(results, sampler, resumed):
    want = results(sampler)[0]["layouts"]["vectorized"]
    ranks = [r["elastic"] for r in results(sampler)]
    shape = {"mesh_1x1": (1, 1), "mesh_2x1": (2, 1), "mesh_2x2_every5":
             (2, 2), "vectorized": None}[resumed]
    for rank, got in enumerate(ranks):
        inside = resumed == "vectorized" and rank == 0 or shape is not None \
            and rank < shape[0] * shape[1]
        if inside:
            assert got[resumed] == want, f"{sampler} {resumed}: rank {rank}"
        else:
            assert got.get(resumed) is None


@pytest.mark.parametrize("sampler", ELASTIC)
def test_elastic_resume_records_the_mesh(results, sampler):
    extra = results(sampler)[0]["elastic"]["extra"]
    assert extra == {"mesh_shape": [2, 1], "num_devices": 2,
                     "chain_method": "parallel"}


@pytest.mark.parametrize("sampler", ELASTIC)
def test_elastic_resume_layout_errors(results, sampler):
    ranks = [r["elastic"] for r in results(sampler)]
    assert [r["rpl301"] for r in ranks] == ["RPL301"] * RANKS
    # (1, 3) takes ranks 0-2; rank 3 lies outside it and takes no chains
    assert [r["rpl303"] for r in ranks] == ["RPL303"] * 3 + [None]


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
