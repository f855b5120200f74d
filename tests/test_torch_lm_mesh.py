"""The LM on a device mesh: the LM half of ``distributed/sharding.py``, the
sharding context of ``models/common.py``, the LM meshes, training with
DTensor parameters, the launcher's ``--mesh`` and int8 gradient
compression, against the JAX package and against the unsharded port.

In process (CPU): the rules and partition specs equal the reference's for
every configuration (a device-free mesh on each side: the port's
``MeshShape``, the reference's ``AbstractMesh``), compression equals the
reference's bit for bit, and a one-rank (1, 1) mesh trains bit-identically
to no mesh.

Across ranks: one spawn of four gloo ranks (``python
tests/test_torch_lm_mesh.py RANK DIR``, a ``file://`` rendezvous in the
test's temporary directory, one thread each) runs reduced gemma-2b and
qwen3-8b in float32 (cut to 2 layers: every DTensor op is a dispatch and
most are collectives) under (4, 1), (2, 2) and (1, 4), with and without
sequence parallelism, two ``shard_accum`` train steps, and the launcher's
``--mesh 2x2`` run (the reduced gemma-2b's 4 layers) resumed under
``--mesh 1x4``; each rank writes its maximum errors against the unsharded
port, which the tests bound.

Tolerances: the loss within LOSS_TOL and every gradient leaf within
GRAD_TOL (tests/test_torch_train.py's bound: the ranks sum the batch, the
heads and the sequence in other orders); parameters after train steps
within PARAM_TOL (tests/test_torch_train.py's bound against the reference:
Adam divides each gradient by its own rms, so a gradient that nearly
cancels moves its step visibly).
"""
from __future__ import annotations

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
ARCHS = ("gemma-2b", "qwen3-8b")
LAYOUTS = ((4, 1), (2, 2), (1, 4))
SEQ, BATCH = 16, 8
LOSS_TOL = 1e-5    # the MAP-free LM loss, ~5.6, float32
GRAD_TOL = 1e-5    # tests/test_torch_train.py's GRAD_TOL
PARAM_TOL = 1e-4   # tests/test_torch_train.py's parameter bound
OPT_TOL = 1e-6     # tests/test_torch_train.py's optimizer bound
LAUNCH = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--seq-len",
          str(SEQ), "--global-batch", str(BATCH), "--log-every", "1",
          "--lr", "1e-2"]


def _cfg(arch, **overrides):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return reduced(get_config(arch), **overrides)


def _sharding_leaves(tree):
    """The ``NamedSharding`` leaves of a ``param_shardings`` tree in
    ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _sharding_leaves(tree[k])]
    return [tree]


def _max_err(got, want):
    from torch.distributed.tensor import DTensor
    got = got.full_tensor() if isinstance(got, DTensor) else got
    return float((got.detach().double() - want.detach().double())
                 .abs().max())


# -- the ranks -----------------------------------------------------------------

def _grads(lm, w, batch):
    from repro_torch.optim import tree_leaves, tree_map
    wg = tree_map(lambda p: p.detach().requires_grad_(), w)
    loss, _ = lm.forward(wg, batch)
    return loss, torch.autograd.grad(loss, tree_leaves(wg))


def _layout_errors(arch, mesh_shape, seq_parallel):
    """The loss's and every gradient leaf's largest error against the
    unsharded port, and whether each parameter lies as
    ``param_shardings`` says."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.models.common import sharding_ctx
    from repro_torch.optim import tree_leaves
    cfg = _cfg(arch, num_layers=2)
    lm = LM(cfg, remat="full")
    batch = SyntheticLMData(cfg.vocab_size, SEQ, BATCH).batch_at(0)
    hp = steps.TrainHParams()
    w = steps.make_train_state(lm, hp, device="cpu")["params"]
    loss, grads = _grads(lm, w, batch)
    mesh = make_host_mesh(mesh_shape, devices="cpu")
    rules = sharding.make_rules(cfg, mesh, seq_parallel=seq_parallel)
    shapes, specs = lm.abstract_params()
    want = _sharding_leaves(sharding.param_shardings(specs, rules, mesh,
                                                     shapes=shapes))
    with sharding_ctx(mesh, rules):
        wd = steps.make_train_state(lm, hp, device="cpu")["params"]
        placed = [tuple(p.placements) == s.placements
                  for p, s in zip(tree_leaves(wd), want)]
        bs = sharding.batch_sharding(rules, mesh)
        loss_d, grads_d = _grads(lm, wd, {
            k: sharding.place(v, mesh, bs.placements)
            for k, v in batch.items()})
    return {"loss": _max_err(loss_d, loss),
            "grad": max(_max_err(a, b) for a, b in zip(grads_d, grads)),
            "placed": all(placed),
            "sharded": sum(any(not p.is_replicate() for p in s.placements)
                           for s in want)}


def _shard_accum_error():
    """Two ``shard_accum`` steps of 2 microbatches on (2, 2) against the
    unsharded steps: the parameters' largest error."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.models.common import sharding_ctx
    from repro_torch.optim import tree_leaves
    cfg = _cfg("gemma-2b", num_layers=2)
    lm = LM(cfg, remat="full")
    data = SyntheticLMData(cfg.vocab_size, SEQ, BATCH)
    hp = steps.TrainHParams(learning_rate=1e-2, warmup_steps=1,
                            total_steps=10, num_microbatches=2,
                            shard_accum=True)
    state = steps.make_train_state(lm, hp, device="cpu")
    step = steps.make_train_step(lm, hp, SEQ * BATCH)
    for i in range(2):
        state, _ = step(state, data.batch_at(i))
    mesh = make_host_mesh((2, 2), devices="cpu")
    rules = sharding.make_rules(cfg, mesh)
    with sharding_ctx(mesh, rules):
        sstate = steps.make_train_state(lm, hp, device="cpu")
        sstep = steps.make_train_step(lm, hp, SEQ * BATCH)
        bs = sharding.batch_sharding(rules, mesh)
        for i in range(2):
            sstate, _ = sstep(sstate, {
                k: sharding.place(v, mesh, bs.placements)
                for k, v in data.batch_at(i).items()})
    return max(_max_err(a, b) for a, b in zip(
        tree_leaves(sstate["params"]), tree_leaves(state["params"])))


def _optimizer_errors():
    """Two updates of each optimizer (after the global-norm clip) on
    DTensor leaves sharded over (2, 2) against the same on plain tensors:
    the largest error of the updates and states, by optimizer."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch import optim
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((2, 2), devices="cpu")
    gen = torch.Generator().manual_seed(0)
    layout = {"a": (Shard(0), Shard(1)), "b": (Shard(1), Replicate()),
              "c": (Replicate(), Shard(0))}
    shapes = {"a": (8, 12), "b": (4, 6), "c": (10,)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) for k, s in shapes.items()}
             for _ in range(2)]

    def on_mesh(tree):
        return {k: sharding.place(v, mesh, layout[k]) for k, v in
                tree.items()}

    out = {}
    for name, opt in (("adamw", optim.adamw(1e-2, weight_decay=0.1)),
                      ("adafactor", optim.adafactor(1e-2)),
                      ("sgd", optim.sgd(1e-2, momentum=0.9))):
        opt = optim.chain(optim.clip_by_global_norm(1.0), opt)
        runs = []
        for place in (lambda t: t, on_mesh):
            p, state, ups = place(params), None, []
            state = opt.init(p)
            for g in grads:
                u, state = opt.update(place(g), state, p)
                ups.append(u)
            runs.append((ups, state))
        errs = [_max_err(a, b) for x, y in zip(runs[1][0], runs[0][0])
                for a, b in zip(optim.tree_leaves(x),
                                optim.tree_leaves(y))]
        errs += [_max_err(a, b) for a, b in zip(
            optim.tree_leaves(runs[1][1]), optim.tree_leaves(runs[0][1]))
            if isinstance(b, torch.Tensor)]
        out[name] = max(errs)
    return out


def _launcher(rank, workdir):
    """``--mesh 2x2`` for 2 steps into ``ck``, then (on a copy) resumed to
    step 4 under ``--mesh 1x4``; ``ck`` stays at step 2 for the test."""
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.optim import tree_leaves
    ck, resumed = (os.path.join(workdir, n) for n in ("ck", "ck_1x4"))
    _, first = train.main(LAUNCH + ["--mesh", "2x2", "--steps", "2",
                                    "--ckpt-dir", ck])
    if rank == 0:
        shutil.copytree(ck, resumed)
    dist.barrier()
    state, second = train.main(LAUNCH + ["--mesh", "1x4", "--steps", "4",
                                         "--ckpt-dir", resumed])
    leaves = [p.full_tensor() for p in tree_leaves(state["params"])]
    if rank == 0:
        torch.save(leaves, os.path.join(workdir, "params_1x4.pt"))
    return {"history": first + second}


def _rank_main(rank, workdir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=RANKS)
    out = {"layouts": {
        f"{arch}/{a}x{b}/sp{int(sp)}": _layout_errors(arch, (a, b), sp)
        for arch in ARCHS for a, b in LAYOUTS for sp in (True, False)}}
    out["shard_accum"] = _shard_accum_error()
    out["optimizers"] = _optimizer_errors()
    out["launcher"] = _launcher(rank, workdir)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


# -- the spawn -------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results and their working directory."""
    workdir = tmp_path_factory.mktemp("lm_mesh")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(workdir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(RANKS)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    out = []
    for rank in range(RANKS):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out, workdir


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "no_sp"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_unsharded(ranks, arch, layout, sp):
    key = f"{arch}/{layout[0]}x{layout[1]}/sp{int(sp)}"
    for rank, got in enumerate(r["layouts"][key] for r in ranks[0]):
        assert got["placed"], f"{key}: rank {rank}'s placements"
        assert got["sharded"] > 0, key
        assert got["loss"] <= LOSS_TOL, (key, rank, got)
        assert got["grad"] <= GRAD_TOL, (key, rank, got)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizers_on_dtensor_leaves_match_plain(ranks, name):
    """The clip (the global norm across the ranks' shards) and each
    optimizer on DTensor leaves, within OPT_TOL of plain tensors."""
    for rank, r in enumerate(ranks[0]):
        assert r["optimizers"][name] <= OPT_TOL, (rank, r["optimizers"])


def test_shard_accum_steps_match_unsharded(ranks):
    for rank, r in enumerate(ranks[0]):
        assert r["shard_accum"] <= PARAM_TOL, (rank, r["shard_accum"])


def _launch(args):
    from repro_torch.launch import train
    return train.main(LAUNCH + args)


def test_launcher_mesh_resumes_match_unsharded_run(ranks, tmp_path):
    """``--mesh 2x2`` for 2 steps, resumed to 4 under ``--mesh 1x4`` (in
    the ranks) and with no mesh (here): each equals the uninterrupted
    unsharded 4-step run within PARAM_TOL, its losses within LOSS_TOL x
    the MAP loss's scale."""
    from repro_torch.optim import tree_leaves
    results, workdir = ranks
    whole, history = _launch(["--steps", "4"])
    want = tree_leaves(whole["params"])
    meshed = torch.load(os.path.join(workdir, "params_1x4.pt"))
    ck = str(tmp_path / "ck")
    shutil.copytree(os.path.join(workdir, "ck"), ck)
    plain, tail = _launch(["--steps", "4", "--ckpt-dir", ck])
    for got in (meshed, tree_leaves(plain["params"])):
        assert max(_max_err(a, b) for a, b in zip(got, want)) <= PARAM_TOL
    for r in results:
        got = r["launcher"]["history"]
        assert [h["step"] for h in got] == [1, 2, 3, 4]
        for a, b in zip(got, history):
            assert a["ce"] == pytest.approx(b["ce"], abs=LOSS_TOL)
            assert a["loss"] == pytest.approx(b["loss"], rel=LOSS_TOL)
    assert [h["step"] for h in tail] == [3, 4]


def test_mesh_checkpoint_restores_through_the_reference(ranks):
    """The ``--mesh 2x2`` run's checkpoint (rank 0 writes full tensors)
    restores through the JAX package's ``checkpoint.restore`` with the
    port's leaves, bit for bit."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.distributed import checkpoint as jckpt
    from repro.launch import steps as jsteps
    from repro.models import LM as JLM
    from repro.models import reduced as j_reduced
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch import steps
    from repro_torch.models import LM
    ck = os.path.join(ranks[1], "ck")
    jlm = JLM(j_reduced(j_get_config("gemma-2b")), remat="full")
    jhp = jsteps.TrainHParams()
    jlike = jsteps.make_train_state(jlm, jhp, rng_key=jax.random.PRNGKey(0))
    jtree, jstep, _ = jckpt.restore(jlike, ck)
    like = steps.make_train_state(LM(_cfg("gemma-2b")), steps.TrainHParams(),
                                  device="cpu")
    tree, step, _ = ckpt.restore(like, ck)
    assert step == jstep == 2
    flat = jax.tree_util.tree_leaves(jtree)
    from repro_torch.distributed.checkpoint import _flatten
    ours = list(_flatten(tree).values())
    assert len(flat) == len(ours)
    for a, b in zip(ours, flat):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))


# -- in process ------------------------------------------------------------------

def _meshes():
    from jax.sharding import AbstractMesh
    from repro_torch.distributed.sharding import MeshShape
    shapes = {"1pod": {"data": 16, "model": 16},
              "mpod": {"pod": 2, "data": 16, "model": 16},
              "host": {"data": 2, "model": 2}}
    return {name: (MeshShape(s), AbstractMesh(tuple(s.values()), tuple(s)))
            for name, s in shapes.items()}


ALL_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b", "gemma-2b", "qwen3-8b",
             "llama3-405b", "qwen1.5-32b", "jamba-v0.1-52b", "mamba2-370m",
             "pixtral-12b", "seamless-m4t-medium")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_rules_equal_the_reference(arch):
    from repro.configs import get_config as j_get_config
    from repro.distributed import sharding as jsharding
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    for mesh, jmesh in _meshes().values():
        for sp in (True, False):
            for scoped in (True, False):
                got = sharding.make_rules(get_config(arch), mesh, sp, scoped)
                want = jsharding.make_rules(j_get_config(arch), jmesh, sp,
                                            scoped)
                assert got == want, (arch, sp, scoped)
    assert sharding.big_ep(get_config(arch)) == \
        jsharding.big_ep(j_get_config(arch))


def test_logical_and_divisible_partitions_equal_the_reference():
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config as j_get_config
    from repro.distributed import sharding as jsharding
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    for mesh, jmesh in _meshes().values():
        rules = sharding.make_rules(get_config("qwen3-8b"), mesh)
        jrules = jsharding.make_rules(j_get_config("qwen3-8b"), jmesh)
        for names in (("embed", "mlp"), (None, "vocab"), ("batch", "seq",
                                                          None), None,
                      ("layers", "heads", "embed")):
            assert sharding.logical_to_partition(names, rules) == tuple(
                jsharding.logical_to_partition(names, jrules))
        for spec, shape in ((("model", "data"), (50280, 1024)),
                            (("model", "data"), (50288, 1024)),
                            ((("data", "model"),), (384,)),
                            ((("data", "model"),), (512,)),
                            ((("pod", "data"), None), (64, 3))):
            if any(a not in mesh.axis_names for e in spec if e
                   for a in ((e,) if isinstance(e, str) else e)):
                continue
            assert sharding.divisible_partition(spec, shape, mesh) == tuple(
                jsharding.divisible_partition(P(*spec), shape, jmesh))
    # an odd vocab stays replicated on its dim
    mesh = sharding.MeshShape({"data": 16, "model": 16})
    assert sharding.divisible_partition(("model", "data"), (50280, 1024),
                                        mesh) == (None, "data")


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_shardings_equal_the_reference(arch, size):
    """The logical-name tree of ``LM.abstract_params`` and each leaf's
    ``param_shardings`` spec on the production meshes and a 2 x 2 host
    mesh, against the reference's (``tuple(P)``)."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.distributed import sharding as jsharding
    from repro.models import LM as JLM
    from repro.models import reduced as j_reduced
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import LM, reduced
    from repro_torch.optim import tree_leaves
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if size == "reduced":
        cfg, jcfg = reduced(cfg), j_reduced(jcfg)
    shapes, specs = LM(cfg).abstract_params()
    jshapes, jspecs = JLM(jcfg).abstract_params()
    is_leaf = lambda x: x is None or isinstance(x, tuple)  # noqa: E731
    assert _sharding_leaves(specs) == jax.tree.leaves(jspecs,
                                                      is_leaf=is_leaf)
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jshapes)]
    assert all(t.device.type == "meta" for t in tree_leaves(shapes))
    for mesh, jmesh in _meshes().values():
        rules = sharding.make_rules(cfg, mesh)
        jrules = jsharding.make_rules(jcfg, jmesh)
        got = _sharding_leaves(sharding.param_shardings(specs, rules, mesh,
                                                        shapes=shapes))
        want = jax.tree.leaves(jsharding.param_shardings(
            jspecs, jrules, jmesh, shapes=jshapes))
        assert [s.spec for s in got] == [tuple(s.spec) for s in want]
        bs = sharding.batch_sharding(rules, mesh)
        assert bs.spec == tuple(jsharding.batch_sharding(jrules, jmesh).spec)
        cs = sharding.cache_sharding(rules, mesh)
        assert cs.spec == tuple(jsharding.cache_sharding(jrules, jmesh).spec)


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import MeshShape, spec_to_placements
    mesh = MeshShape({"pod": 2, "data": 4, "model": 2})
    assert spec_to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_to_placements((), mesh) == (Replicate(),) * 3
    # a mesh dim of one rank never shards: nothing moves over it
    one = MeshShape({"data": 1, "model": 2})
    assert spec_to_placements(("data", "model"), one) == (Replicate(),
                                                          Shard(1))


def test_ep_degree_is_one_off_a_mesh():
    from repro.configs import get_config as j_get_config
    from repro.distributed.sharding import ep_degree_for as j_ep_degree_for
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ep_degree_for
    for arch in ("deepseek-v3-671b", "jamba-v0.1-52b", "gemma-2b"):
        assert ep_degree_for(get_config(arch)) == 1 == \
            j_ep_degree_for(j_get_config(arch))


def test_constrain_off_a_mesh_returns_its_input():
    from repro_torch.models.common import (constrain, logical_to_spec,
                                           sharding_ctx)
    x = torch.zeros(2, 3)
    assert constrain(x, ("batch", "seq")) is x
    with sharding_ctx(None, {"batch": "data", "seq": None}):
        assert constrain(x, ("batch", "seq")) is x
        assert logical_to_spec(("batch", "seq")) == ("data", None)
        # a name absent from the rules leaves the layout alone
        assert logical_to_spec(("batch", "seq_inner")) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_compression_matches_the_reference_bit_for_bit(dtype):
    """Five error-feedback steps on leaves of 300, 17 x 33 and 256
    entries (two not a multiple of the 256 block): the sent gradients, the
    residuals and a round trip equal the reference's bit for bit."""
    import jax.numpy as jnp
    from repro.optim import compression as jcomp
    from repro_torch import optim
    from repro_torch.optim import compression as comp
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(0)
    shapes = {"a": (300,), "b": (17, 33), "c": (256,)}

    def draw(step):
        g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                 * (step + 1)).to(dtype)
             for k, s in shapes.items()}
        return g, {k: jnp.asarray(v.float().numpy()).astype(jdtype)
                   for k, v in g.items()}

    g, jg = draw(0)
    state, jstate = comp.error_feedback_init(g), jcomp.error_feedback_init(jg)
    for step in range(5):
        g, jg = draw(step)
        sent, state = optim.error_feedback_compress(g, state)
        jsent, jstate = jcomp.error_feedback_compress(jg, jstate)
        for k in shapes:
            assert sent[k].dtype == dtype
            np.testing.assert_array_equal(
                sent[k].float().numpy(),
                np.asarray(jsent[k].astype(jnp.float32)))
            np.testing.assert_array_equal(state.residual[k].numpy(),
                                          np.asarray(jstate.residual[k]))
    x = g["b"]
    np.testing.assert_array_equal(
        optim.int8_compress_decompress(x).float().numpy(),
        np.asarray(jcomp.int8_compress_decompress(jg["b"])
                   .astype(jnp.float32)))
    q, scales, n = comp.int8_compress(x)
    jq, jscales, jn = jcomp.int8_compress(jg["b"])
    assert n == jn == 561 and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))


def test_one_rank_mesh_train_step_is_bit_identical():
    """Two AdamW steps of 2 microbatches under a (1, 1) mesh (a one-rank
    gloo group in this process): loss, metrics, parameters and moments
    equal the unsharded steps bit for bit; every leaf is a replicated
    DTensor (a one-rank dim never shards)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.models.common import sharding_ctx
    from repro_torch.optim import tree_leaves
    cfg = _cfg("qwen3-8b")
    lm = LM(cfg)
    hp = steps.TrainHParams(num_microbatches=2, shard_accum=True)
    data = SyntheticLMData(cfg.vocab_size, SEQ, BATCH)
    state = steps.make_train_state(lm, hp, device="cpu")
    step = steps.make_train_step(lm, hp, SEQ * BATCH)
    mesh = make_host_mesh((1, 1), devices="cpu")
    rules = sharding.make_rules(cfg, mesh)
    metrics = []
    for i in range(2):
        state, m = step(state, data.batch_at(i))
        metrics.append(m)
    with sharding_ctx(mesh, rules):
        mstate = steps.make_train_state(lm, hp, device="cpu")
        mstep = steps.make_train_step(lm, hp, SEQ * BATCH)
        bs = sharding.batch_sharding(rules, mesh)
        for i in range(2):
            mstate, mm = mstep(mstate, {
                k: sharding.place(v, mesh, bs.placements)
                for k, v in data.batch_at(i).items()})
            assert all(torch.equal(metrics[i][k], mm[k]) for k in mm)
    for tree in ("params", "opt"):
        for a, b in zip(tree_leaves(state[tree]), tree_leaves(mstate[tree])):
            if isinstance(b, DTensor):
                assert b.placements == (Replicate(), Replicate())
                b = b.to_local()
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_lm_meshes_need_their_rank_counts():
    from repro_torch.core.errors import ReproValueError
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(ReproValueError, match="needs 256 ranks") as e:
        make_production_mesh(devices="cpu")
    assert e.value.code == "RPL301"
    with pytest.raises(ReproValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, devices="cpu")
    with pytest.raises(ReproValueError, match="needs 4 ranks"):
        make_host_mesh((2, 2), devices="cpu")
    mesh = make_host_mesh(devices="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)


def test_mesh_refuses_what_it_does_not_run():
    """mamba2 under a mesh and decoding under a mesh raise RPL501."""
    from repro_torch.core.errors import PENDING, ReproError
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.models.common import sharding_ctx
    mesh = make_host_mesh((1, 1), devices="cpu")
    cfg = _cfg("mamba2-370m")
    lm = LM(cfg)
    w = lm.init(0, device="cpu")
    tokens = torch.zeros(1, 32, dtype=torch.int64)
    with sharding_ctx(mesh, sharding.make_rules(cfg, mesh)):
        with pytest.raises(ReproError, match=PENDING):
            lm.forward(w, {"tokens": tokens, "labels": tokens})
        with pytest.raises(ReproError, match=PENDING):
            LM(_cfg("gemma-2b")).init_cache(1, 8, device="cpu")


def test_a_dtensor_never_reaches_a_kernel_launch():
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((1, 1), devices="cpu")
    x = DTensor.from_local(torch.ones(2, 4), mesh, [Replicate()] * 2)
    with pytest.raises(TypeError, match="DTensor"):
        ops._route("rmsnorm", x)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
