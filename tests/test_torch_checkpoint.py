"""The port's checkpoint format (``repro_torch.distributed.checkpoint``)
against the JAX package's, the executor's checkpoint layout against the
reference executor's, and the train launcher's checkpoint, resume and
preemption, on the CPU.

Every comparison here is exact: values bit for bit (``torch.equal``,
``np.array_equal``), dtypes, devices and Python types equal.
"""
from __future__ import annotations

import json
import os
import signal
from typing import NamedTuple

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.optim import tree_leaves

WARMUP, SAMPLES, EVERY, CHAINS, SAVES = 24, 36, 20, 4, 6


class _Pair(NamedTuple):
    first: object
    second: object


def _same_leaf(a, b):
    """Same Python type, dtype, shape, device and bits."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device
        assert a.shape == b.shape and torch.equal(a, b)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _flat(tree):
    return ckpt._flatten(tree)


def _port_tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.0, 3.0, 0.25],
                                    dtype=torch.bfloat16),
                  "d": torch.tensor(-3, dtype=torch.int32)},
            "s": np.float32(0.1), "n": np.int32(7)}


def _jax_tree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "b": {"c": jnp.asarray([1.5, -2.0, 3.0, 0.25], jnp.bfloat16),
                  "d": jnp.asarray(-3, jnp.int32)},
            "s": np.float32(0.1), "n": np.int32(7)}


def _as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return leaf.numpy()
    return np.asarray(leaf)


def test_checkpoint_roundtrip(tmp_path):
    """tests/test_infra.py:13 on the port."""
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "d": torch.zeros((), dtype=torch.int32)}}
    ckpt.save(tree, str(tmp_path / "ck"), step=7, extra={"data_cursor": 123})
    assert ckpt.latest_step(str(tmp_path / "ck")) == 7
    restored, step, extra = ckpt.restore(tree, str(tmp_path / "ck"))
    assert step == 7 and extra["data_cursor"] == 123
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        _same_leaf(a, b)


def test_checkpoint_atomic_overwrite(tmp_path):
    """tests/test_infra.py:28 on the port: a second save replaces the
    first whole, and no temporary directory is left beside it."""
    ckpt.save({"a": torch.zeros(3)}, str(tmp_path / "ck"), step=1)
    ckpt.save({"a": torch.ones(3)}, str(tmp_path / "ck"), step=2)
    restored, step, _ = ckpt.restore({"a": torch.zeros(3)},
                                     str(tmp_path / "ck"))
    assert step == 2 and torch.equal(restored["a"], torch.ones(3))
    assert os.listdir(tmp_path) == ["ck"]


def test_failed_save_keeps_the_last_checkpoint(tmp_path):
    """A writer that fails mid-write leaves the last complete checkpoint
    and no temporary directory."""
    ckpt.save({"a": torch.zeros(3)}, str(tmp_path / "ck"), step=1)
    with pytest.raises(TypeError, match="leaf 'b'"):
        ckpt.save({"a": torch.ones(3), "b": object()}, str(tmp_path / "ck"),
                  step=2)
    restored, step, _ = ckpt.restore({"a": torch.ones(3)},
                                     str(tmp_path / "ck"))
    assert step == 1 and torch.equal(restored["a"], torch.zeros(3))
    assert os.listdir(tmp_path) == ["ck"]


def test_port_save_is_read_by_the_reference(tmp_path):
    """The port's save, bf16 included, restored by the JAX package."""
    tree = _port_tree()
    ckpt.save(tree, str(tmp_path / "ck"), step=5, extra={"k": [1, 2]})
    got, step, extra = jckpt.restore(_jax_tree(), str(tmp_path / "ck"))
    assert step == 5 and extra == {"k": [1, 2]}
    flat_got, flat_want = _flat(got), _flat(tree)
    assert list(flat_got) == list(flat_want)
    for key, want in flat_want.items():
        have, want = np.asarray(flat_got[key]), _as_numpy(want)
        assert have.dtype == want.dtype, key
        assert have.shape == want.shape, key
        assert have.tobytes() == want.tobytes(), key


def test_reference_save_is_read_by_the_port(tmp_path):
    """The JAX package's save, bf16 included, restored by the port as the
    types of the port's tree."""
    jckpt.save(_jax_tree(), str(tmp_path / "ck"), step=9,
               extra={"arch": "x"})
    like = _port_tree()
    got, step, extra = ckpt.restore(like, str(tmp_path / "ck"))
    assert step == 9 and extra == {"arch": "x"}
    for a, b in zip(tree_leaves(like), tree_leaves(got)):
        _same_leaf(a, b)


def test_npy_files_and_manifest_match_the_reference(tmp_path):
    """The same tree written by both packages: every ``.npy`` byte for
    byte, the manifests equal but for the port's ``kind``."""
    ckpt.save(_port_tree(), str(tmp_path / "port"), step=3,
              extra={"e": 1})
    jckpt.save(_jax_tree(), str(tmp_path / "ref"), step=3, extra={"e": 1})
    mans = {}
    for side in ("port", "ref"):
        with open(tmp_path / side / "manifest.json") as f:
            mans[side] = json.load(f)
    for meta in mans["port"]["leaves"].values():
        assert meta.pop("kind")
    assert mans["port"] == mans["ref"]
    for meta in mans["ref"]["leaves"].values():
        port = (tmp_path / "port" / meta["file"]).read_bytes()
        ref = (tmp_path / "ref" / meta["file"]).read_bytes()
        assert port == ref, meta["file"]


def test_restore_gives_back_exact_types(tmp_path):
    """Tensors keep dtype and device, numpy arrays and scalars their
    dtype, Python scalars their type; containers their kind."""
    tree = {"t": [torch.arange(3, dtype=torch.float32),
                  torch.tensor([0.1], dtype=torch.float64),
                  torch.tensor([1.0, -0.5], dtype=torch.bfloat16),
                  torch.tensor([2 ** 40], dtype=torch.int64),
                  torch.tensor([True, False])],
            "host": _Pair(np.arange(4, dtype=np.float32) / 3,
                          (np.float32(1 / 3), 5, True, 0.1)),
            "none": None}
    ckpt.save(tree, str(tmp_path / "ck"))
    got, _, _ = ckpt.restore(tree, str(tmp_path / "ck"))
    assert type(got["host"]) is _Pair and type(got["host"].second) is tuple
    assert got["none"] is None and type(got["t"]) is list
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        if a is not None:
            _same_leaf(a, b)


@pytest.mark.parametrize("like,match", [
    ({"a": torch.zeros(3, dtype=torch.float64)}, "float64"),
    ({"a": torch.zeros(4)}, r"shape \[4\]"),
    ({"a": np.zeros(3, np.float32)}, "saved as a tensor"),
])
def test_restore_refuses_a_different_leaf(tmp_path, like, match):
    """A dtype, shape or kind that differs from the checkpoint raises;
    nothing is cast."""
    ckpt.save({"a": torch.zeros(3)}, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match=match):
        ckpt.restore(like, str(tmp_path / "ck"))
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        ckpt.restore({"b": torch.zeros(3)}, str(tmp_path / "ck"))


def _normal_model():
    import repro_torch.core as pc
    from repro_torch.core import dist
    pc.sample("x", dist.Normal(0.0, 1.0))


def test_mcmc_last_state_roundtrip(tmp_path):
    """tests/test_mcmc.py:120 on the port: a chain's final state through
    save and restore, every leaf bit-identical and of its type."""
    from repro_torch.core.infer import MCMC, NUTS
    mcmc = MCMC(NUTS(_normal_model, device="cpu"), 100, 100)
    mcmc.run(0)
    (state,) = mcmc.last_state
    ckpt.save(state, str(tmp_path / "mc"), step=100)
    restored, step, _ = ckpt.restore(state, str(tmp_path / "mc"))
    assert step == 100 and type(restored) is type(state)
    for a, b in zip(_flat(state).values(), _flat(restored).values()):
        _same_leaf(a, b)


def _record_saves(module):
    """Wrap ``module.save``: each call's directory name, step and extra."""
    real, calls = module.save, []

    def save(tree, directory, **kw):
        real(tree, directory, **kw)
        calls.append((os.path.basename(directory), kw.get("step"),
                      sorted((kw.get("extra") or {}).keys())))

    module.save = save
    return real, calls


def test_layout_matches_the_reference(tmp_path, monkeypatch):
    """The same run geometry through both executors: the same save calls
    (directory, step, extra keys), the same directories, and the chain
    state's leaf keys the reference's without ``rng_key``."""
    from jax import random

    import repro.core as jpc
    from repro.core import dist as jdist
    from repro.core.infer import MCMC as JMCMC
    from repro.core.infer import NUTS as JNUTS
    from repro_torch.core.infer import MCMC, NUTS

    def jmodel():
        jpc.sample("x", jdist.Normal(1.0, 2.0))

    def model():
        import repro_torch.core as pc
        from repro_torch.core import dist
        pc.sample("x", dist.Normal(1.0, 2.0))

    runs = {}
    for side, module in (("ref", jckpt), ("port", ckpt)):
        real, calls = _record_saves(module)
        try:
            directory = str(tmp_path / side)
            if side == "ref":
                JMCMC(JNUTS(jmodel), num_warmup=WARMUP, num_samples=SAMPLES,
                      num_chains=CHAINS, chain_method="vectorized").run(
                    random.PRNGKey(11), checkpoint_every=EVERY,
                    checkpoint_dir=directory)
            else:
                MCMC(NUTS(model, device="cpu"), WARMUP, SAMPLES,
                     num_chains=CHAINS).run(11, checkpoint_every=EVERY,
                                             checkpoint_dir=directory)
        finally:
            module.save = real
        with open(os.path.join(directory, "state", "manifest.json")) as f:
            manifest = json.load(f)
        runs[side] = (calls, sorted(os.listdir(directory)), manifest)
    (ref_calls, ref_dirs, ref_man), (calls, dirs, man) = (runs["ref"],
                                                          runs["port"])
    assert len(calls) == SAVES and calls == ref_calls
    assert dirs == ref_dirs == ["samples_000024_000044",
                                "samples_000044_000060", "state"]
    assert man["step"] == ref_man["step"] == WARMUP + SAMPLES
    assert sorted(man["extra"]) == sorted(ref_man["extra"])
    for key in ("num_warmup", "num_samples", "num_chains", "chain_method",
                "mesh_shape"):
        assert man["extra"][key] == ref_man["extra"][key], key
    state_keys = [k for k in man["leaves"] if k.startswith("chain_state/")]
    ref_keys = [k for k in ref_man["leaves"] if k != "chain_state/rng_key"]
    assert state_keys == ref_keys
    # the port's draw sources ride in the same write
    assert [k for k in man["leaves"] if not k.startswith("chain_state/")] \
        == [f"draws/{c}" for c in range(CHAINS)]


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "gemma-2b", "--reduced", "--device", "cpu",
          "--seq-len", "32", "--global-batch", "4", "--log-every", "1"]


@pytest.fixture
def deterministic():
    """Deterministic CPU kernels for the launcher's bit-for-bit checks: the
    CPU's ``index_put_`` with accumulate (the embedding's backward) sums in
    thread order above its grain size, so even two uninterrupted runs may
    differ in the last bits there."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _same_state(a, b):
    la, lb = _flat(a), _flat(b)
    assert list(la) == list(lb)
    for key in la:
        _same_leaf(la[key], lb[key])


def test_launcher_resumes_bit_identical(tmp_path, capsys, deterministic):
    """4 checkpointed steps, then a relaunch to 6: the final parameters
    and optimizer state are the uninterrupted 6-step run's, bit for bit."""
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    first, _ = train.main(LAUNCH + ["--steps", "4", "--ckpt-dir", ck,
                                    "--checkpoint-every", "2"])
    assert ckpt.latest_step(ck) == 4 and first["opt"][1].count == 4
    resumed, history = train.main(LAUNCH + ["--steps", "6", "--ckpt-dir", ck,
                                            "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "[train] checkpointed step 2" in out
    assert [h["step"] for h in history] == [5, 6]
    whole, _ = train.main(LAUNCH + ["--steps", "6"])
    assert resumed["step"] == whole["step"] == 6
    assert resumed["opt"][1].count == 6
    _same_state(resumed, whole)
    saved, step, extra = ckpt.restore(whole, ck)
    assert step == 6 and extra == {"arch": "gemma-2b"}
    _same_state(saved, whole)


def test_launcher_sigterm_writes_a_preemption_checkpoint(tmp_path, capsys,
                                                         monkeypatch):
    """SIGTERM during step 3 (sent from the batch's load): the launcher
    finishes the step, writes a checkpoint with ``extra["preempted"]`` and
    returns; the relaunch resumes from step 3."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import train
    batch_at = SyntheticLMData.batch_at

    def preempting(self, step, *args, **kwargs):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return batch_at(self, step, *args, **kwargs)

    ck = str(tmp_path / "ck")
    handler = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(SyntheticLMData, "batch_at", preempting)
    state, _ = train.main(LAUNCH + ["--steps", "8", "--ckpt-dir", ck])
    monkeypatch.setattr(SyntheticLMData, "batch_at", batch_at)
    assert "[train] preemption checkpoint at step 3; exiting" \
        in capsys.readouterr().out
    assert state["step"] == 3
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3 and manifest["extra"]["preempted"] is True
    assert signal.getsignal(signal.SIGTERM) is handler
    resumed, history = train.main(LAUNCH + ["--steps", "5", "--ckpt-dir", ck])
    assert "[train] resumed from step 3" in capsys.readouterr().out
    assert resumed["step"] == 5 and [h["step"] for h in history] == [4, 5]
