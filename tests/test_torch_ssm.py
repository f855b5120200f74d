"""The port's Mamba-2 slice against the JAX package's on the CPU.

The plain ``ssd_scan`` is held against the Pallas kernel in interpret mode
and against both jnp formulations (``ref.ssd_scan``, ``ref.ssd_scan_inline``)
on the same numpy inputs, within ``OP_TABLE``'s 1e-4 (float32 sums in
another order); its gradients (autograd of the plain version, the
``SsdScan`` backward) against ``jax.grad`` of the Pallas kernel, whose
``custom_vjp`` differentiates the jnp reference.  The reduced mamba2 (d_model
128, p = n = 16, chunk 32, float32) runs with the JAX ``LM``'s weights
carried over leaf by leaf: logits within 1e-4, caches within 1e-5, and the
port's decode against its own prefill within the JAX test's 2e-3
(``tests/test_archs_smoke.py:110``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_pallas
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import LM as JLM
from repro.models import count_params as j_count_params
from repro.models import reduced as j_reduced
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.core.errors import PENDING, ReproError
from repro_torch.interop import lm_params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import (ssd_decode_step_ref,
                                          ssd_scan_cuda, ssd_scan_ref)
from repro_torch.launch import serve, steps
from repro_torch.models import LM, count_params, reduced
from repro_torch.models import ssm

TOL = ops.SPECS["ssd_scan"].tol      # 1e-4, as the JAX package's table
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
ARCH = "mamba2-370m"
B, T = 2, 8


def _ssd_inputs(b, l, h, p, g, n, seed, *, decay="test"):
    """Numpy inputs in the JAX kernel test's distribution
    (``tests/test_kernels.py:105``), or, with ``decay="model"``, in
    mamba2's init ranges (dt in [1e-3, 0.1], A in [-16, -1])."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, l, h, p))).astype(np.float32)
    if decay == "model":
        dt = rng.uniform(1e-3, 0.1, (b, l, h)).astype(np.float32)
        A = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(
            np.float32)
        A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((b, l, g, n))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((b, l, g, n))).astype(np.float32)
    D = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# (l, h, p, n, chunk, g): tests/test_kernels.py:100-103's three shapes and a
# case with two B/C groups
SSD_SHAPES = [(128, 2, 16, 32, 32, 1), (256, 4, 16, 32, 64, 1),
              (64, 2, 32, 16, 64, 1), (96, 4, 8, 16, 32, 2)]


@pytest.mark.parametrize("with_D", [True, False])
@pytest.mark.parametrize("l,h,p,n,chunk,g", SSD_SHAPES)
def test_ssd_scan_plain_matches_pallas_and_refs(l, h, p, n, chunk, g,
                                                with_D):
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, l, h, p, g, n, seed=l + h + g)
    Dj = D if with_D else None
    y, st = ssd_scan_ref(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                         D=torch.from_numpy(D) if with_D else None)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert tuple(y.shape) == (2, l, h, p) and tuple(st.shape) == (2, h, p, n)
    pallas = j_ssd_pallas(x, dt, A, Bm, Cm, chunk=chunk, D=Dj,
                          interpret=True)
    for want in (pallas, jref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, D=Dj),
                 jref.ssd_scan_inline(x, dt, A, Bm, Cm, chunk=chunk, D=Dj)):
        assert _max_err(y, want[0]) < TOL
        assert _max_err(st, want[1]) < TOL


@pytest.mark.parametrize("l,h,p,n,chunk,g", SSD_SHAPES[::3])
def test_ssd_scan_entering_state_matches_ref(l, h, p, n, chunk, g):
    """``h0`` against ``ref.ssd_scan(h0=...)`` (the Pallas wrapper hands a
    carried state to that reference), through the op."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, l, h, p, g, n, seed=7)
    h0 = np.random.default_rng(8).standard_normal((2, h, p, n)).astype(
        np.float32)
    y, st = ops.ssd_scan(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                         D=torch.from_numpy(D), h0=torch.from_numpy(h0))
    yr, sr = jref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, D=D, h0=h0)
    assert _max_err(y, yr) < TOL and _max_err(st, sr) < TOL


@pytest.mark.parametrize("with_D", [True, False])
def test_ssd_scan_gradients_match_pallas(with_D):
    """Gradients in x, dt, A, B, C (and D) of ``ops.ssd_scan`` (the
    ``SsdScan`` backward) against ``jax.grad`` of the Pallas kernel in
    interpret mode, at mamba2's decay ranges over chunks of 32 (the
    reference's masked exponent stays finite there)."""
    l, h, p, n, chunk, g = 64, 4, 8, 16, 32, 2
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, l, h, p, g, n, seed=3,
                                      decay="model")
    rng = np.random.default_rng(4)
    gy = rng.standard_normal((2, l, h, p)).astype(np.float32)
    gs = rng.standard_normal((2, h, p, n)).astype(np.float32)

    def loss(x, dt, A, Bm, Cm, D):
        y, st = j_ssd_pallas(x, dt, A, Bm, Cm, chunk=chunk,
                             D=D if with_D else None, interpret=True)
        return (y * gy).sum() + (st * gs).sum()

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    args = [t.requires_grad_() for t in _t(x, dt, A, Bm, Cm, D)]
    y, st = ops.ssd_scan(*args[:5], chunk=chunk,
                         D=args[5] if with_D else None)
    ((y * torch.from_numpy(gy)).sum()
     + (st * torch.from_numpy(gs)).sum()).backward()
    for name, arg, ref in zip("x dt A B C D".split(), args, want):
        if name == "D" and not with_D:
            assert arg.grad is None
            continue
        scale = max(1.0, float(np.max(np.abs(ref))))
        assert np.all(np.isfinite(np.asarray(ref))), name
        assert _max_err(arg.grad, ref) < TOL * scale, name


def test_ssd_scan_gradient_finite_where_reference_overflows():
    """The plain version masks the exponent before ``exp``: where the
    reference's ``where(causal, exp(seg), 0)`` overflows above the diagonal
    and ``jax.grad`` turns ``0 * inf`` into NaN, the port's gradient stays
    finite, and the forward values agree."""
    b, l, h, p, n, chunk = 1, 256, 2, 8, 8, 256
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.full((b, l, h), 0.1, np.float32)
    A = np.array([-16.0, -1.0], np.float32)
    Bm = rng.standard_normal((b, l, 1, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, 1, n)).astype(np.float32)

    def loss(A):
        y, st = jref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        return y.sum() + st.sum()

    assert np.isnan(np.asarray(jax.grad(loss)(A))).any()
    At = torch.from_numpy(A).requires_grad_()
    y, st = ops.ssd_scan(*_t(x, dt), At, *_t(Bm, Cm), chunk=chunk)
    (y.sum() + st.sum()).backward()
    assert bool(torch.isfinite(At.grad).all())
    yr, sr = jref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert _max_err(y.detach(), yr) < TOL
    assert _max_err(st.detach(), sr) < TOL * max(1.0, float(np.abs(sr).max()))


def test_ssd_scan_ragged_length_raises():
    """``l % chunk != 0`` raises on every device, as the reference
    asserts; it is not masked."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 40, 2, 4, 1, 8, seed=0)
    args = _t(x, dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ssd_scan_ref(*args, chunk=32)
    with pytest.raises(ValueError, match="whole number of chunks"):
        ops.ssd_scan(*args, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args, chunk=32)
    with pytest.raises(AssertionError):
        jref.ssd_scan(x, dt, A, Bm, Cm, chunk=32)


@pytest.mark.parametrize("g,with_D", [(1, True), (2, False)])
def test_ssd_decode_step_matches_ref(g, with_D):
    b, h, p, n = 3, 4, 8, 16
    rng = np.random.default_rng(g)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, h)).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    Bm = rng.standard_normal((b, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, g, n)).astype(np.float32)
    D = rng.uniform(0.5, 1.5, h).astype(np.float32) if with_D else None
    y, new = ops.ssd_decode_step(*_t(state, x, dt, A, Bm, Cm),
                                 D=None if D is None else torch.from_numpy(D))
    yr, nr = jref.ssd_decode_step(state, x, dt, A, Bm, Cm, D=D)
    assert _max_err(y, yr) < 1e-5 and _max_err(new, nr) < 1e-5
    assert ops.SPECS["ssd_decode_step"].ref is ssd_decode_step_ref


def test_ssd_decode_consistency():
    """Sequential one-token decode equals the chunked scan over the
    sequence (the port's twin of ``tests/test_kernels.py:142``)."""
    b, l, h, p, g, n = 1, 32, 2, 16, 1, 16
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(b, l, h, p, g, n, seed=5)[:5])
    y_scan, st_scan = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=16)
    st = torch.zeros(b, h, p, n)
    ys = []
    for t in range(l):
        y, st = ssd_decode_step_ref(st, x[:, t], dt[:, t], A, Bm[:, t],
                                    Cm[:, t])
        ys.append(y)
    assert float((torch.stack(ys, 1) - y_scan).abs().max()) < 1e-4
    assert float((st - st_scan).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# the mixer and the LM
# ---------------------------------------------------------------------------

def _pair():
    """The JAX mamba2 LM with its weights, and the port's with the same."""
    jlm = JLM(j_reduced(j_get_config(ARCH)), remat="none")
    jw = jax.device_get(jlm.init(jax.random.PRNGKey(0)))
    lm = LM(reduced(get_config(ARCH)))
    return jlm, jw, lm, lm_params_from_reference(jw, "cpu")


def _tokens(vocab, seed=9):
    return np.random.default_rng(seed).integers(3, vocab, (B, T)).astype(
        np.int32)


def test_params_carry_over_with_their_dtypes():
    jlm, jw, lm, w = _pair()
    ours = lm.init(0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jw)[0]
    assert len(flat_j) == len(list(_leaves(ours)))
    for path, leaf in flat_j:
        node, mine = w, ours
        for p in path:
            node, mine = node[p.key], mine[p.key]
        assert tuple(node.shape) == leaf.shape == tuple(mine.shape)
        assert node.dtype == mine.dtype
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    mixer = w["layers"]["p0"]["mixer"]
    for name in ("A_log", "D", "dt_bias", "norm"):
        assert mixer[name].dtype == torch.float32
    assert "ln2" not in w["layers"]["p0"] and "ffn" not in w["layers"]["p0"]
    # the initializers' ranges: A in [-16, -1], dt_bias = softplus^-1 of
    # [1e-3, 0.1]
    A = -torch.exp(ours["layers"]["p0"]["mixer"]["A_log"])
    assert bool(((A >= -16) & (A <= -1)).all())
    dt = torch.nn.functional.softplus(ours["layers"]["p0"]["mixer"]["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-7) & (dt <= 0.1 + 1e-7)).all())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# (S, with_state): two chunks; one chunk shorter than ssm_chunk; a carried
# state and conv tail
MIXER_CASES = [(64, False), (20, False), (64, True)]


@pytest.mark.parametrize("S,with_state", MIXER_CASES)
def test_ssm_apply_matches_reference(S, with_state):
    jlm, jw, lm, w = _pair()
    cfg, jcfg = lm.cfg, jlm.cfg
    jmix = jax.tree.map(lambda a: a[1], jw["layers"]["p0"]["mixer"])
    mix = lm_params_from_reference(jmix, "cpu")
    d_in, h, n, conv_ch = ssm.ssm_dims(cfg)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    h0 = conv0 = None
    if with_state:
        h0 = (0.1 * rng.standard_normal((B, h, cfg.ssm_head_dim, n))).astype(
            np.float32)
        conv0 = rng.standard_normal(
            (B, cfg.ssm_conv_width - 1, conv_ch)).astype(np.float32)
    jout, (jst, jconv) = jssm.ssm_apply(jcfg, jmix, x, h0=h0, conv0=conv0,
                                        return_state=True)
    out, (st, conv) = ssm.ssm_apply(
        cfg, mix, torch.from_numpy(x),
        h0=None if h0 is None else torch.from_numpy(h0),
        conv0=None if conv0 is None else torch.from_numpy(conv0),
        return_state=True)
    assert _max_err(out, jout) < LOGIT_TOL
    assert _max_err(st, jst) < CACHE_TOL and _max_err(conv, jconv) < CACHE_TOL
    plain = ssm.ssm_apply(cfg, mix, torch.from_numpy(x),
                          h0=None if h0 is None else torch.from_numpy(h0),
                          conv0=None if conv0 is None
                          else torch.from_numpy(conv0))
    assert torch.equal(plain, out)


def test_ssm_decode_matches_reference_and_writes_in_place():
    jlm, jw, lm, w = _pair()
    cfg, jcfg = lm.cfg, jlm.cfg
    jmix = jax.tree.map(lambda a: a[0], jw["layers"]["p0"]["mixer"])
    mix = lm_params_from_reference(jmix, "cpu")
    rng = np.random.default_rng(2)
    jcache = jssm.ssm_init_cache(jcfg, B, jnp.float32)
    cache = ssm.ssm_init_cache(cfg, B, torch.float32, "cpu")
    state, conv = cache["state"], cache["conv"]
    for t in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jssm.ssm_decode(jcfg, jmix, x, jcache)
        out, cache = ssm.ssm_decode(cfg, mix, torch.from_numpy(x), cache)
        assert _max_err(out, jout) < LOGIT_TOL
    assert cache["state"] is state and cache["conv"] is conv
    assert _max_err(state, jcache["state"]) < CACHE_TOL
    assert _max_err(conv, jcache["conv"]) < CACHE_TOL


def test_prefill_and_full_logits_match_reference():
    jlm, jw, lm, w = _pair()
    toks = _tokens(lm.cfg.vocab_size)
    jfull = jax.jit(lambda w, t: jlm.forward(w, {"tokens": t},
                                             return_logits=True))(jw, toks)
    jlast = jax.jit(lambda w, t: j_make_prefill_step(jlm)(
        w, {"tokens": t}))(jw, toks)
    full = lm.forward(w, {"tokens": torch.from_numpy(toks)},
                      return_logits=True)
    last = steps.make_prefill_step(lm)(w, {"tokens": torch.from_numpy(toks)})
    assert tuple(full.shape) == (B, T, lm.cfg.vocab_size)
    assert _max_err(full, jfull) < LOGIT_TOL
    assert _max_err(last, jlast) < LOGIT_TOL


def test_loss_matches_reference():
    jlm, jw, lm, w = _pair()
    toks, labels = _tokens(lm.cfg.vocab_size), _tokens(lm.cfg.vocab_size, 10)
    jloss, jm = jax.jit(lambda w, t, l: jlm.forward(
        w, {"tokens": t, "labels": l}))(jw, toks, labels)
    loss, m = lm.forward(w, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
    for key in ("ce", "z_loss", "loss"):
        assert float(m[key]) == pytest.approx(float(jm[key]), abs=LOGIT_TOL)


def test_decode_and_caches_match_reference():
    """T = 8 teacher-forced decode steps: every step's logits, then the
    stacked state and conv caches leaf by leaf, against the JAX LM's."""
    jlm, jw, lm, w = _pair()
    toks = _tokens(lm.cfg.vocab_size)
    jcache = jlm.init_cache(B, T)
    jstep = jax.jit(jlm.decode_step)
    cache = lm.init_cache(B, T, device="cpu")
    for t in range(T):
        jlogits, jcache = jstep(jw, toks[:, t:t + 1], jcache, jnp.asarray(t))
        logits, cache = lm.decode_step(
            w, torch.from_numpy(toks[:, t:t + 1]), cache, t)
        assert _max_err(logits, jlogits) < LOGIT_TOL
    ref = lm_params_from_reference(jax.device_get(jcache))
    d_in, h, n, conv_ch = ssm.ssm_dims(lm.cfg)
    L = lm.cfg.num_layers
    shapes = {"state": ((L, B, h, lm.cfg.ssm_head_dim, n), torch.float32),
              "conv": ((L, B, lm.cfg.ssm_conv_width - 1, conv_ch),
                       torch.float32)}
    for name, (shape, dtype) in shapes.items():
        mine = cache["layers"]["p0"]["ssm"][name]
        want = ref["layers"]["p0"]["ssm"][name]
        assert tuple(mine.shape) == tuple(want.shape) == shape
        assert mine.dtype == want.dtype == dtype
        assert float((mine - want).abs().max()) < CACHE_TOL


def test_decode_matches_prefill():
    """The port's twin of ``tests/test_archs_smoke.py:110``: teacher-forced
    decode reproduces the full-sequence logits, the stacked caches written
    in place."""
    lm = LM(reduced(get_config(ARCH)))
    w = lm.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(lm.cfg.vocab_size))
    full = lm.forward(w, {"tokens": toks}, return_logits=True)
    cache = lm.init_cache(B, T, device="cpu")
    state = cache["layers"]["p0"]["ssm"]["state"]
    outs = []
    for t in range(T):
        logits, cache = lm.decode_step(w, toks[:, t:t + 1], cache, t)
        outs.append(logits)
    assert cache["layers"]["p0"]["ssm"]["state"] is state
    assert bool((state != 0).any())
    assert float((torch.stack(outs, dim=1) - full).abs().max()) < 2e-3


def test_full_size_model_and_cache_shapes():
    """``LM(mamba2-370m)`` builds, its parameter count is the reference's,
    and its decode cache is one stacked float32 state and one bf16 conv
    tail for the 48 layers; without a card the entry points raise RPL502."""
    cfg = get_config(ARCH)
    lm = LM(cfg)
    assert count_params(cfg) == j_count_params(j_get_config(ARCH))
    cache = lm.init_cache(1, 4, device="cpu")["layers"]["p0"]["ssm"]
    assert tuple(cache["state"].shape) == (48, 1, 32, 64, 128)
    assert cache["state"].dtype == torch.float32
    assert tuple(cache["conv"].shape) == (48, 1, 3, 2304)
    assert cache["conv"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(ReproError, match="RPL502"):
            lm.init_cache(1, 4)


def test_hybrid_family_still_raises_pending():
    with pytest.raises(ReproError, match=PENDING):
        LM(reduced(get_config("jamba-v0.1-52b")))


def test_serve_main_runs_and_is_deterministic(capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--tokens", "4"]
    first = serve.main(argv)
    second = serve.main(argv)
    seq = first["tokens"]
    assert tuple(seq.shape) == (2, 12) and seq.dtype == torch.int32
    assert torch.equal(seq, second["tokens"])
    assert bool(((seq >= 0) & (seq < 256)).all())
    assert f"[serve] {ARCH}" in capsys.readouterr().out
    lm = LM(reduced(get_config(ARCH)))
    w = lm.init(torch.Generator().manual_seed(0))
    last = steps.make_prefill_step(lm)(w, {"tokens": seq[:, :8]})
    assert float((first["first_logits"] - last).abs().max()) < 2e-3
