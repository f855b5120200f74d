"""The numerical design of the bf16 tensor-core ``softmax_xent`` kernels
(``csrc/softmax_xent.cu``: ``xent_fwd_tc_kernel`` and ``dlogits_tc_kernel``)
and of the backward's products, emulated in plain torch on the CPU.

Forward: bf16 operands, products summed in float32 16 deep at a time (one
``mma.sync.m16n8k16`` step, summed from zero and added to the float32
accumulator), 128-column vocab tiles folded into a running (max, sum of
exponentials, label logit) per row, and the vocab splits merged in split
order.  Backward: the logits recomputed the same way, ``dl = exp(logits -
lse) coef - onehot g_ce`` fed to the products as a bf16 hi part plus a bf16
lo part, ``dx = hi W^T + lo W^T`` (over ``TC_DEPTH``-deep vocab slices)
and ``dw = [x; x]^T [hi; lo]`` summed in float32 and rounded once to
bf16.

Held against ``repro.kernels.ref.softmax_xent``, the Pallas kernel in
interpret mode and ``jax.vjp``: the float32 outputs (ce, z_loss, lse)
within ``softmax_xent``'s OP_TABLE bound (1e-4), dx and dw within one bf16
step of the float32-computed gradient (``ops.BF16_RTOL``/``BF16_ATOL``).  A
last test records why ``dl`` enters as hi + lo: rounded once to bf16 it
misses that gate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.softmax_xent import softmax_xent as j_xent
from repro_torch.kernels import ops
from repro_torch.kernels.softmax_xent import TC_DEPTH

NEG_INF = -1e30   # the kernels' running max before the first column
MMA_K = 16        # depth of one mma.sync.m16n8k16 step
VOCAB_TILE = 128  # XENT_TILES' BV
TILES_PER_SPLIT = 3  # small, so V = 1000 makes three splits, the last short
XENT_TOL = 1e-4   # OP_TABLE's softmax_xent bound (float32 outputs)
T, D, V = 256, 64, 1000  # a ragged V: 7 full vocab tiles and one of 104


def _inputs(T, d, V, tied, seed):
    """bf16 x, the (d, V) unembedding (the transpose of a (V, d) embedding
    when ``tied``), labels, and the incoming gradients of ce and z_loss, all
    from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, d), dtype=np.float32))
    shape = (V, d) if tied else (d, V)
    w = torch.from_numpy(0.3 * rng.standard_normal(shape, dtype=np.float32))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    w = w.T if tied else w
    labels = torch.from_numpy(rng.integers(0, V, T).astype(np.int32))
    gce = torch.from_numpy(rng.uniform(0.5, 1.5, T).astype(np.float32))
    gzl = torch.from_numpy(rng.uniform(0.5, 1.5, T).astype(np.float32))
    return x, w, labels, gce, gzl


def _logits(x, w, c0=0, c1=None):
    """Columns [c0, c1) of x w in float32, summed 16 deep at a time."""
    xf, wf = x.float(), w.float()[:, c0:c1]
    acc = torch.zeros(xf.shape[0], wf.shape[1])
    for k0 in range(0, xf.shape[1], MMA_K):
        acc = acc + xf[:, k0:k0 + MMA_K] @ wf[k0:k0 + MMA_K]
    return acc


def emulate_fwd(x, w, labels, z_loss_weight):
    """The forward kernel and its merge: ``(ce, z_loss, lse)`` float32."""
    T, V = x.shape[0], w.shape[1]
    rows = torch.arange(T)
    tiles = -(-V // VOCAB_TILE)
    parts = []
    for s0 in range(0, tiles, TILES_PER_SPLIT):
        m = torch.full((T,), NEG_INF)
        s = torch.zeros(T)
        ll = torch.zeros(T)
        for vt in range(s0, min(tiles, s0 + TILES_PER_SPLIT)):
            c0, c1 = vt * VOCAB_TILE, min(V, (vt + 1) * VOCAB_TILE)
            logits = _logits(x, w, c0, c1)
            m_new = torch.maximum(m, logits.amax(1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(1)
            m = m_new
            hit = (labels >= c0) & (labels < c1)
            ll[hit] = logits[rows[hit], (labels[hit] - c0).long()]
        parts.append((m, s, ll))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    total, label_logit = torch.zeros(T), torch.zeros(T)
    for m, s, ll in parts:  # split order
        total = total + s * torch.exp(m - mx)
        label_logit = label_logit + ll
    lse = mx + torch.log(total)
    return lse - label_logit, z_loss_weight * lse * lse, lse


def _split(a):
    """float32 -> (hi, lo), both bf16 values (held in float32)."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def emulate_bwd(x, w, labels, lse, gce, gzl, z_loss_weight, split=True):
    """The dlogits kernel and the products: ``(dx, dw)`` in bf16.  With
    ``split=False`` dl enters the products rounded once to bf16."""
    coef = gce + 2.0 * z_loss_weight * lse * gzl
    dl = torch.exp(_logits(x, w) - lse[:, None]) * coef[:, None]
    dl[torch.arange(x.shape[0]), labels.long()] -= gce
    terms = _split(dl) if split else (dl.to(torch.bfloat16).float(),)
    xf, wf = x.float(), w.float()
    dx = sum(term[:, v0:v0 + TC_DEPTH] @ wf[:, v0:v0 + TC_DEPTH].T
             for v0 in range(0, w.shape[1], TC_DEPTH) for term in terms)
    dw = sum(xf.T @ term for term in terms)
    return dx.to(torch.bfloat16), dw.to(torch.bfloat16)


def _jax_vjp(x, w, labels, gce, gzl, z_loss_weight):
    """dx, dw of ``sum(gce ce + gzl z_loss)`` through the jnp reference, in
    float32 on the bf16 operands' values."""
    def f(x, w):
        return jref.softmax_xent(x, w, jnp.asarray(labels.numpy()),
                                 z_loss_weight=z_loss_weight)

    _, vjp = jax.vjp(f, x.float().numpy(), w.float().numpy())
    return tuple(torch.from_numpy(np.array(g))
                 for g in vjp((gce.numpy(), gzl.numpy())))


def _gate_ratio(got, want):
    """Largest |got - want| over the one-bf16-step bound (<= 1 holds)."""
    bound = ops.BF16_RTOL * want.float().abs() + ops.BF16_ATOL
    return float(((got.float() - want.float()).abs() / bound).max())


def _close(got, want, tol):
    err = float((got.float() - torch.from_numpy(np.array(want)).float())
                .abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("zlw", [0.0, 1e-2])
def test_emulated_forward_matches_reference(tied, zlw):
    x, w, labels, _, _ = _inputs(T, D, V, tied, seed=1)
    ce, zl, lse = emulate_fwd(x, w, labels, zlw)
    jce, jzl = jref.softmax_xent(x.float().numpy(), w.float().numpy(),
                                 labels.numpy(), z_loss_weight=zlw)
    _close(ce, jce, XENT_TOL)
    _close(zl, jzl, XENT_TOL)
    logits = x.float().numpy() @ w.float().numpy()
    _close(lse, jax.scipy.special.logsumexp(logits, axis=-1), XENT_TOL)


@pytest.mark.parametrize("zlw", [0.0, 1e-2])
def test_emulated_forward_matches_pallas_kernel(zlw):
    """V = 1024: the Pallas kernel asserts V % 512 == 0 (the port masks a
    ragged V, held against the reference above)."""
    x, w, labels, _, _ = _inputs(T, D, 1024, False, seed=2)
    ce, zl, _ = emulate_fwd(x, w, labels, zlw)
    jce, jzl = j_xent(jnp.asarray(x.float().numpy()),
                      jnp.asarray(w.float().numpy()),
                      jnp.asarray(labels.numpy()), zlw, True)
    _close(ce, jce, XENT_TOL)
    _close(zl, jzl, XENT_TOL)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("zlw", [0.0, 1e-2])
def test_emulated_backward_matches_jax_vjp(tied, zlw):
    x, w, labels, gce, gzl = _inputs(T, D, V, tied, seed=3)
    _, _, lse = emulate_fwd(x, w, labels, zlw)
    dx, dw = emulate_bwd(x, w, labels, lse, gce, gzl, zlw)
    jdx, jdw = _jax_vjp(x, w, labels, gce, gzl, zlw)
    assert _gate_ratio(dx, jdx) <= 1.0
    assert _gate_ratio(dw, jdw) <= 1.0


def test_once_rounded_dlogits_misses_the_bf16_gate():
    """dl is a float32 operand of both products.  Rounded once to bf16 it
    carries 2^-9 of itself, and the sums of dx (over the vocab) and dw
    (over the rows), whose terms cancel, miss the one-step bf16 gate; as hi
    + lo (2^-17) the same products hold it.  Margins at this seed: the split
    at 0.50 of the bound, the once-rounded dl at 115x (dx) and 59x (dw);
    seeds 3-4 in both layouts read 39-115x."""
    x, w, labels, gce, gzl = _inputs(T, D, V, False, seed=4)
    _, _, lse = emulate_fwd(x, w, labels, 1e-2)
    jdx, jdw = _jax_vjp(x, w, labels, gce, gzl, 1e-2)
    split = emulate_bwd(x, w, labels, lse, gce, gzl, 1e-2)
    once = emulate_bwd(x, w, labels, lse, gce, gzl, 1e-2, split=False)
    split_ratio = max(_gate_ratio(split[0], jdx), _gate_ratio(split[1], jdw))
    once_ratio = min(_gate_ratio(once[0], jdx), _gate_ratio(once[1], jdw))
    assert split_ratio <= 1.0, split_ratio
    assert once_ratio > 10.0, once_ratio
