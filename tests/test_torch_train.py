"""The training slice of the PyTorch port against the JAX package, on the
CPU at reduced sizes: the same inputs, made with numpy, go through both.

The kernels' plain versions stand for the CUDA kernels here (the kernels
themselves are held against them on the card: tests/test_torch_cuda.py,
chip_smoke.py).  The JAX side runs its Pallas kernels in interpret mode.
Tolerances are stated beside each check: float32 throughout, the two
packages summing in other orders.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import optimizers as joptimizers
from repro.configs import get_config as j_get_config
from repro.core import bayes as jbayes
from repro.core import dist as jdist
from repro.core.handlers import seed as jseed
from repro.core.handlers import trace as jtrace
from repro.core.primitives import param as jparam
from repro.core.primitives import sample as jsample
from repro.data import SyntheticLMData as JSyntheticLMData
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro.kernels.softmax_xent import softmax_xent as j_xent
from repro.launch import steps as jsteps
from repro.models import LM as JLM
from repro.models import reduced as j_reduced
from repro_torch import optim
from repro_torch.optim import optimizers
from repro_torch.configs import get_config
from repro_torch.core import bayes, dist
from repro_torch.core.errors import PENDING, ReproError
from repro_torch.core.handlers import seed, trace
from repro_torch.core.primitives import param, sample
from repro_torch.data import SyntheticLMData
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.interop import (lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref
from repro_torch.kernels.softmax_xent import (softmax_xent_bwd,
                                              softmax_xent_ref)
from repro_torch.launch import steps, train
from repro_torch.models import LM, reduced

RMS_TOL = 2e-5     # OP_TABLE's rmsnorm bound
ATTN_TOL = 2e-4    # OP_TABLE's attention bound
XENT_TOL = 1e-4    # OP_TABLE's softmax_xent bound
OPT_TOL = 1e-6     # the optimizers: elementwise float32 math, same order
GRAD_TOL = 1e-5    # a reduced LM's gradients (entries up to ~1e-1)
# the log-prior of a reduced LM sums ~6e5 terms near -3.2 in float32: the
# JAX package's sum lands 2.7e-5 (relative) from the float64 value, the
# port's within 1e-7 (test_log_prior_of_a_reduced_lm_matches_float64), so
# the log-prior, and the MAP loss it dominates, are compared to 5e-5
PRIOR_RTOL = 5e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# kernels: plain versions against the JAX kernels' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 64), (256, 24)])
def test_rmsnorm_bwd_ref_matches_jax_grad(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: j_rmsnorm(x, w, 1e-6, True), x, w)
    jdx, jdw = vjp(g)
    dx, dw = rmsnorm_bwd_ref(_t(x), _t(w), _t(g))
    _close(dx, jdx, RMS_TOL)
    _close(dw, jdw, RMS_TOL)
    # ops.rmsnorm differentiates through the same backward
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    odx, odw = torch.autograd.grad(ops.rmsnorm(xt, wt), (xt, wt), _t(g))
    _close(odx, jdx, RMS_TOL)
    _close(odw, jdw, RMS_TOL)


# (B, S, H, K, dq, dv, causal): GQA and MQA, causal and not, dq != dv
FLASH_CASES = [(2, 64, 4, 2, 16, 16, True), (2, 64, 4, 2, 16, 16, False),
               (1, 64, 4, 1, 32, 16, True), (1, 64, 2, 1, 16, 24, False)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_ref_matches_jax_grad(case):
    B, S, H, K, dq, dv, causal = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, dq)).astype(np.float32)
    k = rng.standard_normal((B, S, K, dq)).astype(np.float32)
    v = rng.standard_normal((B, S, K, dv)).astype(np.float32)
    do = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, causal=causal, bq=32,
                                             bk=32, interpret=True), q, k, v)
    want = vjp(do)
    o, lse = flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    got = flash_attention_bwd_ref(_t(q), _t(k), _t(v), o, lse, _t(do),
                                  causal=causal)
    for a, b in zip(got, want):
        _close(a, b, ATTN_TOL)


@pytest.mark.parametrize("zlw", [0.0, 1e-2])
def test_softmax_xent_and_backward_match_jax(zlw):
    T, d, V = 64, 32, 1024
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, V))).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    gce, gzl = (rng.standard_normal(T).astype(np.float32) for _ in range(2))
    (jce, jzl), vjp = jax.vjp(
        lambda x, w: j_xent(x, w, jnp.asarray(labels), zlw, True), x, w)
    jdx, jdw = vjp((gce, gzl))
    ce, zl, lse = softmax_xent_ref(_t(x), _t(w), _t(labels), zlw)
    _close(ce, jce, XENT_TOL)
    _close(zl, jzl, XENT_TOL)
    # the chunked backward, in chunks of 5 rows (a ragged last chunk)
    dx, dw = softmax_xent_bwd(_t(x), _t(w), _t(labels), lse, _t(gce),
                              _t(gzl), zlw, chunk_elements=5 * V)
    _close(dx, jdx, XENT_TOL)
    _close(dw, jdw, XENT_TOL)
    # through ops, with w the transpose of a (V, d) matrix (a tied embedding)
    xt = _t(x).requires_grad_()
    emb = _t(w.T.copy()).requires_grad_()
    oce, ozl = ops.softmax_xent(xt, emb.T, _t(labels), z_loss_weight=zlw)
    odx, oemb = torch.autograd.grad((oce * _t(gce)).sum()
                                    + (ozl * _t(gzl)).sum(), (xt, emb))
    _close(oce, jce, XENT_TOL)
    _close(odx, jdx, XENT_TOL)
    _close(oemb.T, jdw, XENT_TOL)


def test_softmax_xent_ref_matches_reference_at_ragged_sizes():
    """T and V that the Pallas kernel's blocks do not divide: the port's
    versions take them (a difference by design); the plain version agrees
    with ``ref.softmax_xent``."""
    T, d, V = 37, 24, 301
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((d, V))).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    jce, jzl = jref.softmax_xent(x, w, labels, z_loss_weight=1e-4)
    ce, zl, _ = softmax_xent_ref(_t(x), _t(w), _t(labels), 1e-4)
    _close(ce, jce, XENT_TOL)
    _close(zl, jzl, XENT_TOL)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda o: o.sgd(0.1),
    "sgd_momentum": lambda o: o.sgd(0.1, momentum=0.9),
    "adam": lambda o: o.adam(1e-2),
    "adamw": lambda o: o.adamw(1e-2, weight_decay=0.1),
    "adamw_schedule": lambda o: o.adamw(
        1e-2, weight_decay=0.0, schedule=o.warmup_cosine(1e-2, 2, 5)),
    "adafactor": lambda o: o.adafactor(1e-2),
    "chain_clip_scale": lambda o: o.chain(o.clip_by_global_norm(0.5),
                                          o.scale(-0.1)),
    "scale_by_schedule": lambda o: o.scale_by_schedule(
        o.warmup_cosine(1e-1, 1, 4)),
}


def _opt_tree(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"v": rng.standard_normal(4).astype(np.float32),
                  "m": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def _tensors(tree):
    return optim.tree_map(_t, tree)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(4)
    params = _opt_tree(rng)
    jopt, opt = OPTIMIZERS[name](joptimizers), OPTIMIZERS[name](optimizers)
    jp, p = params, _tensors(params)
    js, s = jopt.init(jp), opt.init(p)
    for _ in range(3):
        grads = _opt_tree(rng)
        jup, js = jopt.update(grads, js, jp)
        up, s = opt.update(_tensors(grads), s, p)
        for a, b in zip(optim.tree_leaves(up),
                        jax.tree_util.tree_leaves(jup)):
            _close(a, b, OPT_TOL)
        jp = joptim.apply_updates(jp, jup)
        p = optim.apply_updates(p, up)
    for a, b in zip(optim.tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        _close(a, b, OPT_TOL)
    for a, b in zip(optim.tree_leaves(s), jax.tree_util.tree_leaves(js)):
        _close(torch.as_tensor(a), b, OPT_TOL)


def test_global_norm_and_warmup_cosine_match_reference():
    tree = _opt_tree(np.random.default_rng(5))
    _close(optim.global_norm(_tensors(tree)), joptim.global_norm(tree), 1e-6)
    js, s = joptim.warmup_cosine(3e-4, 10, 100), optim.warmup_cosine(3e-4, 10,
                                                                     100)
    for step in (0, 1, 9, 10, 11, 55, 100, 150):
        assert float(s(step)) == pytest.approx(
            float(js(jnp.asarray(step))), rel=1e-6)


# ---------------------------------------------------------------------------
# the log-prior through the handlers, and lift
# ---------------------------------------------------------------------------

def test_log_prior_value_and_gradient_match_reference():
    rng = np.random.default_rng(6)
    params = {"embed": rng.standard_normal((16, 8)).astype(np.float32),
              "layers": {"w": rng.standard_normal((2, 8, 8)).astype(
                  np.float32),
                  "scale": rng.standard_normal((2, 8)).astype(np.float32)},
              "final": rng.standard_normal(8).astype(np.float32)}
    jlp, jg = jax.value_and_grad(lambda p: jbayes.log_prior(p, 3.0))(params)
    p = optim.tree_map(lambda a: _t(a).requires_grad_(), params)
    lp = bayes.log_prior(p, 3.0)
    g = torch.autograd.grad(lp, optim.tree_leaves(p), allow_unused=True,
                            materialize_grads=True)
    lp = lp.detach()
    assert float(lp) == pytest.approx(float(jlp), rel=1e-6)
    for a, b in zip(g, jax.tree_util.tree_leaves(jg)):
        _close(a, b, 1e-6)
    # norm scales (ndim 1) carry no prior: their gradient is 0 (the leaves
    # in sorted-key order: embed, final, layers/scale, layers/w)
    assert float(g[1].abs().max()) == 0.0 and p["final"].dim() == 1


def test_log_prior_of_a_reduced_lm_matches_float64():
    jlm, jw = _lm_pair("gemma-2b")
    want = sum(float((-0.5 * (np.asarray(a, np.float64) / 10.0) ** 2
                      - np.log(10.0) - 0.5 * np.log(2 * np.pi)).sum())
               for a in jax.tree_util.tree_leaves(jw) if a.ndim >= 2)
    got = float(bayes.log_prior(lm_params_from_reference(jw), 10.0))
    assert got == pytest.approx(want, rel=1e-7)
    assert float(jbayes.log_prior(jw, 10.0)) == pytest.approx(
        want, rel=PRIOR_RTOL)


def test_log_prior_is_scored_through_sample_sites():
    """The prior's weights are observed ``sample`` sites of a trace: a
    handler sees each weight leaf of ndim >= 2 as a site."""
    seen = []

    class record(trace):
        def postprocess_message(self, msg):
            seen.append((msg["name"], msg["is_observed"]))
            super().postprocess_message(msg)

    with record():
        bayes.log_prior({"a": torch.ones(2, 3), "b": {"c": torch.ones(4, 1)},
                         "n": torch.ones(5)})
    assert seen == [("a", True), ("b/c", True)]


def _lift_model(x, y=None):
    w = param("w", shape=(x.shape[-1],),
              init_fn=lambda g, s, d: 0.1 * torch.randn(s, generator=g))
    sample("y", dist.Normal(x @ w, 0.5).to_event(1), obs=y)


def _j_lift_model(x, y=None):
    w = jparam("w", shape=(x.shape[-1],),
               init_fn=lambda k, s, d: 0.1 * jax.random.normal(k, s))
    jsample("y", jdist.Normal(x @ w, 0.5).to_event(1), obs=y)


def test_lift_converts_param_to_sample_as_the_reference():
    """tests/test_bayes.py:45 on both packages: the lifted ``param`` site
    is a latent ``sample`` site of the prior's shape."""
    x = np.random.default_rng(7).standard_normal((20, 3)).astype(np.float32)
    jlifted = jbayes.lift(_j_lift_model, prior_fn=lambda m: jdist.Normal(
        0.0, 1.0).expand(m["kwargs"]["shape"]).to_event(1))
    jtr = jtrace(jseed(jlifted, jax.random.PRNGKey(1))).get_trace(x)
    lifted = bayes.lift(_lift_model, prior_fn=lambda m: dist.Normal(
        0.0, 1.0).expand(m["kwargs"]["shape"]).to_event(1))
    tr = trace(seed(lifted, 1)).get_trace(_t(x))
    for t in (jtr, tr):
        assert t["w"]["type"] == "sample"
        assert not t["w"]["is_observed"]
        assert tuple(t["w"]["value"].shape) == (3,)
    assert tr["w"]["fn"].event_shape == (3,)


# ---------------------------------------------------------------------------
# the LM's loss and gradients, and the train step
# ---------------------------------------------------------------------------

def _lm_pair(arch):
    jlm = JLM(j_reduced(j_get_config(arch)), remat="none")
    jw = jax.device_get(jlm.init(jax.random.PRNGKey(0)))
    return jlm, jw


def _lm_batch(vocab, B=2, S=16, seed_=8):
    rng = np.random.default_rng(seed_)
    return {"tokens": rng.integers(3, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(3, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_lm_loss_metrics_and_gradients_match_reference(arch):
    jlm, jw = _lm_pair(arch)
    batch = _lm_batch(256)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda w, b: jlm.forward(w, b), has_aux=True))(jw, batch)
    tbatch = {k: _t(v) for k, v in batch.items()}
    for remat in ("none", "full"):
        lm = LM(reduced(get_config(arch)), remat=remat)
        w = optim.tree_map(lambda a: a.requires_grad_(),
                           lm_params_from_reference(jw))
        loss, m = lm.forward(w, tbatch)
        g = torch.autograd.grad(loss, optim.tree_leaves(w))
        loss = loss.detach()
        assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
        assert set(m) == set(jm)
        for key in m:
            assert float(m[key].detach()) == pytest.approx(float(jm[key]),
                                                           abs=1e-5)
        for a, b in zip(g, jax.tree_util.tree_leaves(jg)):
            _close(a, b, GRAD_TOL)


def test_lm_remat_only_where_a_backward_can_happen(monkeypatch):
    """``remat="full"`` checkpoints each layer when a backward can follow
    (grad enabled and a leaf requiring grad), and never for serving, which
    runs with grad enabled but no leaf requiring it."""
    from repro_torch.models import zoo
    calls = []

    def counting(fn, *args, **kwargs):
        calls.append(1)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)

    monkeypatch.setattr(zoo, "checkpoint", counting)
    lm = LM(reduced(get_config("gemma-2b")), remat="full")
    w = lm.init(0, device="cpu")
    batch = {k: _t(v) for k, v in _lm_batch(256).items()}
    served = lm.forward(w, batch)[0]
    assert not calls and not served.requires_grad
    with torch.no_grad():
        lm.forward(optim.tree_map(lambda a: a.requires_grad_(), w), batch)
    assert not calls
    trained = lm.forward(w, batch)[0]
    assert len(calls) == sum(g.n for g in lm.groups) > 0
    assert float(trained.detach()) == float(served)


def test_lm_remat_dots_raises_pending():
    with pytest.raises(ReproError, match=PENDING):
        LM(reduced(get_config("gemma-2b")), remat="dots")


@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_steps_match_reference(n_mb):
    """Three AdamW MAP steps from the same state on the same batches.
    Tolerances: the metrics to 1e-5 (the log-prior and MAP loss to
    PRIOR_RTOL); the Adam moments mu and nu to 1e-7 and 1e-9 (their largest
    entries are ~1e-2 and ~2e-5); the params to 1e-4, 1 % of one step at
    learning rate 1e-2: Adam divides each gradient by its own rms, so where
    a gradient nearly cancels, float32 rounding moves its normalized step
    visibly (4.5e-5 at most here); 99.9 % of the params agree to 5e-6."""
    cfg = j_reduced(j_get_config("gemma-2b"))
    jlm = JLM(cfg, remat="full")
    hp = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
              num_microbatches=n_mb)
    jhp = jsteps.TrainHParams(**hp)
    jstate = jsteps.make_train_state(jlm, jhp, rng_key=jax.random.PRNGKey(0))
    state = train_state_from_reference(jax.device_get(jstate))
    data = JSyntheticLMData(cfg.vocab_size, 16, 4, seed=0)
    jstep = jax.jit(jsteps.make_train_step(jlm, jhp, total_tokens=4 * 16))
    lm = LM(reduced(get_config("gemma-2b")), remat="full")
    step = steps.make_train_step(lm, steps.TrainHParams(**hp),
                                 total_tokens=4 * 16)
    for i in range(3):
        batch = jax.device_get(data.batch_at(i))
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {k: _t(v) for k, v in batch.items()})
        for key in jm:
            rel = PRIOR_RTOL if key in ("log_prior", "loss") else 1e-5
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=rel,
                                                  abs=1e-5), key
    jstate = jax.device_get(jstate)
    assert state["step"] == int(jstate["step"]) == 3
    adam, jadam = state["opt"][1], jstate["opt"][1]
    assert adam.count == int(jadam.count) == 3
    for tree, jtree, tol in ((adam.mu, jadam.mu, 1e-7),
                             (adam.nu, jadam.nu, 1e-9),
                             (state["params"], jstate["params"], 1e-4)):
        errs = []
        for a, b in zip(optim.tree_leaves(tree),
                        jax.tree_util.tree_leaves(jtree)):
            _close(a, b, tol)
            errs.append(np.abs(a.numpy() - np.asarray(b)).ravel())
    assert np.quantile(np.concatenate(errs), 0.999) <= 5e-6


def test_train_step_pending_options_raise():
    """The sharded-accumulation options, once pending, are the plain step
    off a mesh: ``shard_accum`` and ``grad_shardings`` (plain tensors have
    no placements to take) give the same state bit for bit."""
    cfg = reduced(get_config("gemma-2b"))
    lm = LM(cfg)
    data = SyntheticLMData(cfg.vocab_size, 16, 4)
    runs = []
    for hp, shardings in ((steps.TrainHParams(num_microbatches=2), None),
                          (steps.TrainHParams(num_microbatches=2,
                                              shard_accum=True), None),
                          (steps.TrainHParams(num_microbatches=2), {})):
        state = steps.make_train_state(lm, hp, device="cpu")
        step = steps.make_train_step(lm, hp, 64, grad_shardings=shardings)
        for i in range(2):
            state, m = step(state, data.batch_at(i))
        runs.append((optim.tree_leaves(state["params"]), m))
    for leaves, m in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][0]))
        assert all(torch.equal(m[k], runs[0][1][k]) for k in m)


def test_default_hparams_match_reference():
    from repro.models.config import SHAPES as J_SHAPES
    from repro_torch.models.config import SHAPES
    for arch in ("gemma-2b", "qwen3-8b", "qwen1.5-32b", "llama3-405b"):
        for key in ("train_4k",):
            got = steps.default_hparams(get_config(arch), SHAPES[key])
            want = jsteps.default_hparams(j_get_config(arch), J_SHAPES[key])
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_synthetic_data_is_deterministic_by_step():
    data = SyntheticLMData(vocab_size=50, seq_len=32, global_batch=4,
                           mean_doc_len=8)
    a, b = data.batch_at(3), data.batch_at(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], data.batch_at(4)["tokens"])
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 32)
    toks = a["tokens"]
    assert bool(((toks >= 3) | (toks == 2)).all() and (toks < 50).all())
    assert bool((toks == 2).any())     # EOS boundaries at rate 1/8
    assert torch.equal(a["labels"][:, :-1], toks[:, 1:])
    assert bool((a["labels"][:, -1] == 2).all())
    halves = [data.batch_at(3, r, 2)["tokens"] for r in range(2)]
    assert halves[0].shape == (2, 32) and not torch.equal(*halves)


def test_train_launcher_runs_on_cpu(capsys, tmp_path):
    state, history = train.main(["--arch", "gemma-2b", "--reduced",
                                 "--device", "cpu", "--steps", "3",
                                 "--seq-len", "32", "--global-batch", "4",
                                 "--microbatches", "2", "--log-every", "1"])
    assert state["step"] == 3 and state["opt"][1].count == 3
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "[train] step 3/3" in capsys.readouterr().out
    # --ckpt-dir writes a checkpoint of the train state at --steps
    ck = str(tmp_path / "ck")
    train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                "--steps", "1", "--seq-len", "32", "--global-batch", "4",
                "--ckpt-dir", ck])
    assert ckpt.latest_step(ck) == 1
    assert os.path.exists(os.path.join(ck, "params__embed.npy"))
    # --mesh 1x1 (a one-rank gloo group in this process) equals no mesh
    # bit for bit; a 2x2 mesh needs four ranks
    args = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps",
            "2", "--seq-len", "32", "--global-batch", "4",
            "--microbatches", "2", "--log-every", "1"]
    plain, plain_hist = train.main(args)
    meshed, mesh_hist = train.main(args + ["--mesh", "1x1"])
    assert mesh_hist == plain_hist
    for a, b in zip(optim.tree_leaves(plain["params"]),
                    optim.tree_leaves(meshed["params"])):
        assert torch.equal(a, b.to_local())
    with pytest.raises(ReproError, match="needs 4 ranks") as e:
        train.main(args + ["--mesh", "2x2"])
    assert e.value.code == "RPL301"
