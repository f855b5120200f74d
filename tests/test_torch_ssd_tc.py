"""The numerical design of the bf16 tensor-core SSD scan
(``csrc/ssd_scan.cu:ssd_tc_kernel``), emulated in plain torch on the CPU:
bf16 operands, every product accumulated in float32 over 16-deep steps,
the chunk walked in the kernel's 64-row query tiles and 64-key tiles, each
half of a key tile (and every other 16-deep step of the entering state's
product) summed apart by its key group and the two groups' y added at the
end, and the three float32 operands fed to their products as a bf16 hi
part plus a bf16 lo part (or one part, or three, to show what the split
buys):

- the masked, decayed scores ``S o exp(cum_i - cum_j) o dt_j`` in ``P X``
  (off the diagonal the decay as a row factor times a key factor, as the
  kernel forms it);
- the entering state in ``diag(exp(cum)) C state^T``, split once a chunk;
- ``x o w`` (``w_j = dt_j exp(cum_end - cum_j)``) in the state update
  ``state = exp(cum_end) state + (x o w)^T B``, the state float32 across
  chunks.

``cum`` is summed in order with separate float32 roundings, as the kernel
does.  Held against ``ssd_scan_ref`` under the port's bf16 gate
(``ops.BF16_RTOL``/``BF16_ATOL`` on y: one bf16 step of the float32-computed
value; the float32 state within 1e-4 of its largest entry), and at one
shape against the Pallas kernel in interpret mode."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as j_ssd_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_ref

TI = 64          # query rows per tile
KT = 64          # keys per tile
KG = 2           # key groups: each takes KT / KG keys of every key tile
STEP = 16        # the depth of one mma.sync.m16n8k16
STATE_TOL = ops.SPECS["ssd_scan"].tol   # 1e-4 of the largest state entry


def _parts(x, parts):
    """float32 -> the bf16 terms (held in float32) it enters a product as:
    x rounded once, or hi + lo, or hi + mid + lo."""
    out, rest = [], x
    for _ in range(parts - 1):
        term = rest.to(torch.bfloat16).float()
        out.append(term)
        rest = rest - term
    return out + [rest.to(torch.bfloat16).float()]


def _mm(a, b, first=0, every=1):
    """a @ b accumulated in float32 over 16-deep steps, in order: the steps
    first, first + every, ... (one key group's share)."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(STEP * first, a.shape[-1], STEP * every):
        acc = acc + a[..., k0:k0 + STEP] @ b[..., k0:k0 + STEP, :]
    return acc


def _cum(prod):
    """The in-order sum over the chunk axis (-1), each step rounded to
    float32 (the kernel's one thread; ``torch.cumsum`` may accumulate in
    double on the CPU)."""
    out, s = torch.empty_like(prod), torch.zeros(prod.shape[:-1])
    for i in range(prod.shape[-1]):
        s = s + prod[..., i]
        out[..., i] = s
    return out


def _decayed(s, cum, dtc, i0, i1, j0, j1):
    """The scores of query rows [i0, i1) and keys [j0, j1) of a chunk,
    masked and decayed as the kernel does: a warp's 16 rows whose tile holds
    a key after their first row (a diagonal tile) take exp(cum_i - cum_j)
    dt_j under the causal mask; the others, every key at or before every
    row, take the row factor exp(cum_i - cum_r) times the key factor
    exp(cum_r - cum_j) dt_j, r the tile's last key."""
    rows, keys = torch.arange(i0, i1)[:, None], torch.arange(j0, j1)[None, :]
    cum_i, cum_j = cum[..., i0:i1, None], cum[..., None, j0:j1]
    dt_j = dtc[..., None, j0:j1]
    direct = torch.where(rows >= keys, s * torch.exp(
        (cum_i - cum_j).clamp_max(0.0)) * dt_j, 0.0)
    r = j0 + KT - 1
    if r >= cum.shape[-1]:  # a ragged chunk's last tile
        return direct
    cum_r = cum[..., r:r + 1, None]
    factored = s * (torch.exp(cum_i - cum_r)
                    * (torch.exp(cum_r - cum_j) * dt_j))
    warp_first = i0 + (rows - i0) // 16 * 16
    return torch.where(j0 + KT - 1 > warp_first, direct, factored)


def emulate_ssd(x, dt, A, B, C, chunk, D=None, h0=None, p_parts=2,
                state_parts=2, xw_parts=2):
    """The kernel's arithmetic: ``(y bf16, final state float32)``.  x, B, C
    bf16 (b, l, h, p) and (b, l, g, n); dt, A, D, h0 float32."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    # (b, h, l, .): head hh reads group hh // rep
    xh = x.float().permute(0, 2, 1, 3)
    Bh = B.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    Ch = C.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    dth = dt.float().permute(0, 2, 1)                     # (b, h, l)
    st = (torch.zeros(b, h, p, n) if h0 is None else h0.float().clone())
    y = torch.empty(b, h, l, p)
    for t0 in range(0, l, chunk):
        dtc = dth[..., t0:t0 + chunk]
        cum = _cum(dtc * A.float()[None, :, None])
        xc, Bc, Cc = (t[..., t0:t0 + chunk, :] for t in (xh, Bh, Ch))
        st_terms = _parts(st, state_parts)
        for i0 in range(0, chunk, TI):
            i1 = min(i0 + TI, chunk)
            Ci, cum_i = Cc[..., i0:i1, :], cum[..., i0:i1, None]
            acc = []  # one per key group
            for kg in range(KG):
                a = sum(_mm(Ci, s.transpose(-1, -2), kg, KG)
                        for s in st_terms)
                acc.append(a * torch.exp(cum_i))
            for j0 in range(0, i1, KT):
                s = _mm(Ci, Bc[..., j0:min(j0 + KT, i1), :].transpose(-1, -2))
                pm = _decayed(s, cum, dtc, i0, i1, j0, j0 + s.shape[-1])
                for kg in range(KG):  # the group's keys of the tile
                    k0 = kg * KT // KG
                    k1 = min((kg + 1) * KT // KG, pm.shape[-1])
                    if k1 <= k0:
                        continue
                    for term in _parts(pm[..., k0:k1], p_parts):
                        acc[kg] = acc[kg] + _mm(term,
                                                xc[..., j0 + k0:j0 + k1, :])
            if D is not None:
                acc[0] = acc[0] + D.float()[None, :, None, None] \
                    * xc[..., i0:i1, :]
            y[..., t0 + i0:t0 + i1, :] = sum(acc[1:], acc[0])
        cend = cum[..., -1:]
        w = dtc * torch.exp(cend - cum)                   # (b, h, c)
        st = st * torch.exp(cend)[..., None]
        xw = (xc * w[..., None]).transpose(-1, -2)        # (b, h, p, c)
        for j0 in range(0, chunk, KT):
            for term in _parts(xw[..., j0:j0 + KT], xw_parts):
                st = st + _mm(term, Bc[..., j0:j0 + KT, :])
    return y.permute(0, 2, 1, 3).to(torch.bfloat16), st


def _inputs(b, l, h, p, g, n, seed, h0=False):
    """bf16 x, B, C and float32 dt, A, D (and h0) from numpy's
    ``default_rng(seed)``, in mamba2's ranges (``chip_smoke._ssd_inputs``):
    dt in [1e-3, 0.1], A in [-16, -1]."""
    rng = np.random.default_rng(seed)

    def bf16(scale, shape):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)
        ).to(torch.bfloat16)
    x = bf16(0.5, (b, l, h, p))
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, (b, l, h)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(1.0, 16.0, h).astype(np.float32))
    Bm, Cm = bf16(0.3, (b, l, g, n)), bf16(0.3, (b, l, g, n))
    D = torch.from_numpy(rng.uniform(0.5, 1.5, h).astype(np.float32))
    s0 = torch.from_numpy((0.1 * rng.standard_normal((b, h, p, n)))
                          .astype(np.float32)) if h0 else None
    return x, dt, A, Bm, Cm, D, s0


def _gate(got, want):
    """Largest error over the bf16 gate's bound (<= 1 passes)."""
    err = (got.float() - want.float()).abs()
    return float((err / (ops.BF16_RTOL * want.float().abs()
                         + ops.BF16_ATOL)).max())


def _state_err(got, want):
    """State error over 1e-4 of its largest entry (<= 1 passes)."""
    return float((got - want).abs().max()) / (
        STATE_TOL * max(1.0, float(want.abs().max())))


# (b, l, h, p, g, n, chunk): the reduced mamba2's widths (16 heads of p =
# n = 16, chunks of 32), the main path's structure at a small size (several
# 256-chunks of 64 x 128), two groups over ragged 200-chunks, p = 40 with n
# = 24 (padded to 16-multiples in the kernel)
CASES = [(2, 64, 16, 16, 1, 16, 32), (1, 768, 2, 64, 1, 128, 256),
         (1, 400, 4, 32, 2, 128, 200), (1, 96, 4, 40, 2, 24, 32)]
OPERANDS = ["", "D", "D,h0"]


@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_within_bf16_gate(case, operands):
    b, l, h, p, g, n, chunk = case
    x, dt, A, Bm, Cm, D, h0 = _inputs(b, l, h, p, g, n,
                                      seed=CASES.index(case),
                                      h0="h0" in operands)
    D = D if "D" in operands else None
    y, st = emulate_ssd(x, dt, A, Bm, Cm, chunk, D=D, h0=h0)
    ry, rst = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, D=D, h0=h0)
    assert _gate(y, ry) <= 1.0
    assert _state_err(st, rst) <= 1.0


def test_emulation_matches_pallas_in_interpret_mode():
    """The same bf16-valued inputs through the Pallas kernel (interpret
    mode, float32 inside, as ``tests/test_torch_ssm.py`` runs it)."""
    b, l, h, p, g, n, chunk = 1, 128, 2, 32, 1, 64, 64
    x, dt, A, Bm, Cm, D, _ = _inputs(b, l, h, p, g, n, seed=11)
    y, st = emulate_ssd(x, dt, A, Bm, Cm, chunk, D=D)
    jy, jst = j_ssd_pallas(*(t.float().numpy() for t in (x, dt, A, Bm, Cm)),
                           chunk=chunk, D=D.numpy(), interpret=True)
    jy, jst = (torch.from_numpy(np.array(jax.device_get(a)))
               for a in (jy, jst))
    assert _gate(y, jy) <= 1.0
    assert _state_err(st, jst) <= 1.0


def test_split_reconstructs_float32():
    """hi + lo carries a float32 value to 2^-16 of itself, hi + mid + lo to
    2^-24, over the exponents the scores, the state and x o w take."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)
                         * 10.0 ** rng.uniform(-20, 20, 100_000)
                         .astype(np.float32))
    for parts, rel in ((2, 2.0 ** -16), (3, 2.0 ** -24)):
        terms = _parts(x, parts)
        assert all(torch.equal(t, t.to(torch.bfloat16).float())
                   for t in terms)
        assert bool(((sum(terms) - x).abs() <= rel * x.abs()).all())


# The design record: two 256-chunks of the main path's widths, seed 0.
RECORD = (1, 512, 2, 64, 1, 128, 256)


def test_scores_rounded_once_to_bf16_break_the_gate():
    """The masked, decayed scores rounded once to bf16 before ``P X`` (as
    a bf16 SSD kernel on the tensor cores would feed them) miss the gate
    the float32 function holds; as hi + lo they stay within it.  A kernel
    that drops the split needs this test changed."""
    x, dt, A, Bm, Cm, D, _ = _inputs(*RECORD[:-1], seed=0)
    chunk = RECORD[-1]
    ry, rst = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, D=D)
    y, st = emulate_ssd(x, dt, A, Bm, Cm, chunk, D=D)
    assert _gate(y, ry) <= 1.0 and _state_err(st, rst) <= 1.0
    y1, _ = emulate_ssd(x, dt, A, Bm, Cm, chunk, D=D, p_parts=1)
    assert _gate(y1, ry) > 10.0


def test_state_and_xw_rounded_once_break_the_gate():
    """The other two float32 operands: the entering state rounded once to
    bf16 misses y's gate (2.1x at the record shape, whose second chunk is
    the first with a state), ``x o w`` rounded once misses the state's 1e-4
    (1.8x); so both enter as hi + lo.  A kernel that drops either split
    needs this test changed."""
    x, dt, A, Bm, Cm, D, _ = _inputs(*RECORD[:-1], seed=0)
    chunk = RECORD[-1]
    ry, rst = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk, D=D)
    y, _ = emulate_ssd(x, dt, A, Bm, Cm, chunk, D=D, state_parts=1)
    assert _gate(y, ry) > 1.0
    _, st = emulate_ssd(x, dt, A, Bm, Cm, chunk, D=D, xw_parts=1)
    assert _state_err(st, rst) > 1.0
