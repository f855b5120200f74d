"""The port's LM serving stack against the JAX package's on the CPU.

Configs are compared field by field; a reduced model's weights are drawn by
the JAX package and carried over with ``interop.lm_params_from_reference``,
so both packages run the same float32 model on the same numpy tokens.
Tolerances: logits within 1e-4 (float32 through the same operations in
another order, logits of order 1) and caches within 1e-5; the port's own
decode-against-prefill check uses the JAX test's 2e-3
(``tests/test_archs_smoke.py:112``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import LM as JLM
from repro.models import count_params as j_count_params
from repro.models import reduced as j_reduced
from repro.models.config import SHAPES as J_SHAPES
from repro.models.common import rope_frequencies as j_rope_frequencies
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.errors import PENDING, ReproError
from repro_torch.interop import lm_params_from_reference
from repro_torch.launch import serve, steps
from repro_torch.models import LM, count_params, reduced
from repro_torch.models.common import rope_frequencies
from repro_torch.models.config import SHAPES

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
DENSE = ("qwen3-8b", "gemma-2b", "qwen1.5-32b", "llama3-405b")
# mamba2-370m builds too: tests/test_torch_ssm.py holds it to the reference
PENDING_ARCHS = tuple(a for a in ARCHS if a not in DENSE + ("mamba2-370m",))
B, T = 2, 8


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    port, ref = get_config(arch), j_get_config(arch)
    assert _fields(port) == _fields(ref)
    assert _fields(reduced(port)) == _fields(j_reduced(ref))
    assert reduced(port).torch_dtype == torch.float32
    assert port.torch_dtype == torch.bfloat16


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma-2b"])
def test_count_params_matches_reference(arch):
    assert count_params(get_config(arch)) == j_count_params(
        j_get_config(arch))


@pytest.mark.parametrize("arch", PENDING_ARCHS)
def test_unported_families_raise_pending(arch):
    with pytest.raises(ReproError, match=PENDING):
        LM(reduced(get_config(arch)))


def test_int8_kv_cache_and_loss_raise_pending():
    """The int8 KV cache still raises ``RPL501``; the training loss, pending
    until the training slice, now matches the JAX ``LM``'s (name kept)."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-8b")),
                              kv_cache_int8=True)
    lm = LM(cfg)
    with pytest.raises(ReproError, match=PENDING):
        lm.init_cache(1, 4, device="cpu")
    jlm, jw, lm, w = _pair("qwen3-8b")
    toks = _tokens(lm.cfg.vocab_size)
    labels = _tokens(lm.cfg.vocab_size, seed=10)
    jloss, jm = jax.jit(lambda w, t, l: jlm.forward(
        w, {"tokens": t, "labels": l}))(jw, toks, labels)
    loss, m = lm.forward(w, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
    assert float(loss) == pytest.approx(float(jloss), abs=LOGIT_TOL)
    for key in ("ce", "z_loss", "loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]), abs=LOGIT_TOL)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    lm = LM(reduced(get_config("qwen3-8b")))
    with pytest.raises(ReproError, match="RPL502"):
        lm.init(0)
    with pytest.raises(ReproError, match="RPL502"):
        lm.init_cache(1, 4)


def test_rope_tables_match_reference():
    for hd, base in ((32, 1e6), (128, 1e4)):
        cos, sin = rope_frequencies(hd, 64, base=base)
        jcos, jsin = j_rope_frequencies(hd, 64, base=base)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)


def _pair(arch):
    """The JAX LM with its weights, and the port's LM with the same ones."""
    jcfg = j_reduced(j_get_config(arch))
    jlm = JLM(jcfg, remat="none")
    jw = jax.device_get(jlm.init(jax.random.PRNGKey(0)))
    lm = LM(reduced(get_config(arch)))
    return jlm, jw, lm, lm_params_from_reference(jw, "cpu")


def _tokens(vocab, seed=9):
    return np.random.default_rng(seed).integers(3, vocab, (B, T)).astype(
        np.int32)


def test_params_carry_over_leaf_by_leaf():
    jlm, jw, lm, w = _pair("qwen3-8b")
    ours = lm.init(0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jw)[0]
    for path, leaf in flat_j:
        node, mine = w, ours
        for p in path:
            node, mine = node[p.key], mine[p.key]
        assert tuple(node.shape) == leaf.shape == tuple(mine.shape)
        assert node.dtype == mine.dtype
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_full_logits_match_reference(arch):
    jlm, jw, lm, w = _pair(arch)
    toks = _tokens(lm.cfg.vocab_size)
    jfull = jax.jit(lambda w, t: jlm.forward(w, {"tokens": t},
                                             return_logits=True))(jw, toks)
    jprefill = j_make_prefill_step(jlm)
    jlast = jax.jit(lambda w, t: jprefill(w, {"tokens": t}))(jw, toks)
    full = lm.forward(w, {"tokens": torch.from_numpy(toks)},
                      return_logits=True)
    last = steps.make_prefill_step(lm)(w, {"tokens": torch.from_numpy(toks)})
    assert tuple(full.shape) == (B, T, lm.cfg.vocab_size)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0,
                               atol=LOGIT_TOL)


def test_decode_and_cache_match_reference():
    """T = 8 teacher-forced decode steps: the logits of every step and the
    final KV cache against the JAX LM's."""
    jlm, jw, lm, w = _pair("qwen3-8b")
    toks = _tokens(lm.cfg.vocab_size)
    jcache = jlm.init_cache(B, T)
    jstep = jax.jit(jlm.decode_step)
    cache = lm.init_cache(B, T, device="cpu")
    for t in range(T):
        jlogits, jcache = jstep(jw, toks[:, t:t + 1], jcache, jnp.asarray(t))
        logits, cache = lm.decode_step(
            w, torch.from_numpy(toks[:, t:t + 1]), cache, t)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=LOGIT_TOL)
    for name in ("k", "v"):
        mine = cache["layers"]["p0"]["kv"][name]
        ref = np.asarray(jcache["layers"]["p0"]["kv"][name])
        assert tuple(mine.shape) == ref.shape == (
            lm.cfg.num_layers, B, T, lm.cfg.num_kv_heads, lm.cfg.head_dim)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=CACHE_TOL)


def test_decode_matches_prefill():
    """The port's own KV-cache check (``tests/test_archs_smoke.py:91``):
    teacher-forced decode reproduces the full-sequence logits, and the cache
    is written in place (one tensor for all layers, never reallocated)."""
    lm = LM(reduced(get_config("qwen3-8b")))
    w = lm.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(lm.cfg.vocab_size))
    full = lm.forward(w, {"tokens": toks}, return_logits=True)
    cache = lm.init_cache(B, T, device="cpu")
    k_store = cache["layers"]["p0"]["kv"]["k"]
    outs = []
    for t in range(T):
        logits, cache = lm.decode_step(w, toks[:, t:t + 1], cache, t)
        outs.append(logits)
    assert cache["layers"]["p0"]["kv"]["k"] is k_store
    assert bool((k_store != 0).all())
    dec = torch.stack(outs, dim=1)
    assert float((dec - full).abs().max()) < 2e-3


def test_serve_step_samples_through_a_site():
    lm = LM(reduced(get_config("qwen3-8b")))
    w = lm.init(0, device="cpu")
    cache = lm.init_cache(B, T, device="cpu")
    step = steps.make_serve_step(lm, temperature=0.7, return_logits=True)
    tok = torch.full((B, 1), 5, dtype=torch.int32)
    nxt, cache, logits = step(w, cache, tok, 0, torch.Generator().manual_seed(3))
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (B, 1)
    assert bool(((nxt >= 0) & (nxt < lm.cfg.vocab_size)).all())
    # a very low temperature draws the argmax
    cold = steps.make_serve_step(lm, temperature=1e-4)
    again, _ = cold(w, lm.init_cache(B, T, device="cpu"), tok, 0,
                    torch.Generator().manual_seed(4))
    assert torch.equal(again[:, 0].long(), logits.argmax(-1))


def test_serve_main_runs_and_is_deterministic(capsys):
    argv = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--tokens", "4"]
    first = serve.main(argv)
    second = serve.main(argv)
    seq = first["tokens"]
    assert tuple(seq.shape) == (2, 12) and seq.dtype == torch.int32
    assert torch.equal(seq, second["tokens"])
    prompt = np.random.default_rng(1).integers(3, 256, (2, 8))
    np.testing.assert_array_equal(seq[:, :8].numpy(), prompt)
    assert bool(((seq >= 0) & (seq < 256)).all())
    assert "[serve] qwen3-8b" in capsys.readouterr().out
    # the logits at P - 1 are what a prefill of the prompt returns
    lm = LM(reduced(get_config("qwen3-8b")))
    w = lm.init(torch.Generator().manual_seed(0))
    last = steps.make_prefill_step(lm)(w, {"tokens": seq[:, :8]})
    assert float((first["first_logits"] - last).abs().max()) < 2e-3
