"""The port's discrete posterior sampling (``infer_discrete``, ``enum`` in
sample mode, ``markov``'s forward-filter/backward-sample through
``ops.enum_chain_alphas`` and ``ops.enum_chain_sample``) against the JAX
package's, on the same numpy inputs:

- level 1: the forward filter's alphas against the reference's
  ``lax.scan`` within 1e-12 in float64; ``enum_chain_sample_ref`` against
  the reference's backward ``lax.scan`` of ``random.categorical`` given the
  noise of the same keys, index for index, and against a numpy loop with
  planted ties (the lowest index wins);
- level 2: ``infer_discrete`` on the reference's mixture and HMM in
  float64, the reference's Gumbel noise injected through a draw source
  that replays its key schedule: the reference's draws, index for index;
- level 3: marginals of M = 400 draws within 0.1 of the exact posterior
  (softmax of the mixture, forward-backward smoothing of the HMM).

The ``enum_chain_sample`` kernel itself is tested in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax, random

import repro.core as jpc
from repro.core import dist as jdist
from repro.core.handlers import substitute as j_substitute
from repro.core.infer import infer_discrete as j_infer_discrete
from repro.core.infer import markov as j_markov
from repro.kernels import ref as jref
from repro_torch import core as pc
from repro_torch.core import dist
from repro_torch.core.errors import ReproError
from repro_torch.core.handlers import substitute
from repro_torch.core.infer import (enum, infer_discrete, markov,
                                    print_summary)
from repro_torch.kernels import ops
from repro_torch.kernels.enum_contract import (enum_chain_ref,
                                               enum_chain_sample_ref)

# the mixture and the HMM of tests/test_enum.py, with numpy parameters
K, N = 3, 7
WEIGHTS = np.array([0.2, 0.5, 0.3])
MUS = np.array([-2.0, 0.0, 2.0])
X = np.random.default_rng(0).standard_normal(N) * 2.0
KH, V, T = 3, 5, 6
_rng = np.random.default_rng(1)
THETA = _rng.dirichlet(np.full(KH, 2.0), size=KH)
PHI = _rng.dirichlet(np.full(V, 1.0), size=KH)
W = _rng.integers(0, V, T)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gmm(x):
    mu = pc.sample("mu", dist.Normal(x.new_zeros(K), x.new_ones(K))
                   .to_event(1))
    with pc.plate("data", x.shape[0]):
        z = pc.sample("z", dist.Categorical(
            probs=torch.as_tensor(WEIGHTS, dtype=x.dtype)),
            infer={"enumerate": "parallel"})
        pc.sample("obs", dist.Normal(mu[z], 1.0), obs=x)


def j_gmm(x):
    mu = jpc.sample("mu", jdist.Normal(jnp.zeros(K), jnp.ones(K)).to_event(1))
    with jpc.plate("data", x.shape[0]):
        z = jpc.sample("z", jdist.Categorical(probs=jnp.asarray(WEIGHTS)),
                       infer={"enumerate": "parallel"})
        jpc.sample("obs", jdist.Normal(mu[z], 1.0), obs=x)


def hmm(w):
    f64 = torch.float64
    th = pc.sample("theta", dist.Dirichlet(
        torch.full((KH, KH), 2.0, dtype=f64)).to_event(1))
    ph = pc.sample("phi", dist.Dirichlet(
        torch.full((KH, V), 1.0, dtype=f64)).to_event(1))

    def step(z_prev, w_t):
        z = pc.sample("z", dist.Categorical(probs=th[z_prev]))
        pc.sample("w", dist.Categorical(probs=ph[z]), obs=w_t)
        return z

    return markov(step, 0, w, name="chain")


def j_hmm(w):
    th = jpc.sample("theta",
                    jdist.Dirichlet(jnp.full((KH, KH), 2.0)).to_event(1))
    ph = jpc.sample("phi", jdist.Dirichlet(jnp.full((KH, V), 1.0)).to_event(1))

    def step(z_prev, w_t):
        z = jpc.sample("z", jdist.Categorical(probs=th[z_prev]))
        jpc.sample("w", jdist.Categorical(probs=ph[z]), obs=w_t)
        return z

    return j_markov(step, 0, w, name="chain")


class JaxDraws:
    """``infer_discrete``'s draw source replaying the JAX package's keys:
    the root's two ``fresh()`` are ``split(rng_key)`` (``k_seed``,
    ``k_disc``); the handler's ``fresh()`` is its ``fresh_key`` (``key, sub
    = split(key)``); a chain's ``gumbel((T, K))`` is ``markov``'s schedule
    (``key_last, key_rest = split(sub)``, ``split(key_rest, T - 1)``), a
    parallel source's ``gumbel`` one ``split`` per site."""

    def __init__(self, key, kind="root", chain=False):
        self.key, self.kind, self.chain = key, kind, chain
        self.generator = torch.Generator().manual_seed(0)
        self._pair = list(random.split(key)) if kind == "root" else None

    def fresh(self):
        if self.kind == "root":
            return JaxDraws(self._pair.pop(0), "handler", self.chain)
        self.key, sub = random.split(self.key)
        kind = "chain" if self.chain else "sites"
        self.chain = False  # the chain's is the first; the sites' follow
        return JaxDraws(sub, kind)

    def gumbel(self, shape, dtype):
        jdtype = {torch.float32: jnp.float32, torch.float64: jnp.float64}[
            dtype]
        if self.kind == "chain":
            steps, k = shape[0], shape[-1]
            key_last, key_rest = random.split(self.key)
            keys = random.split(key_rest, steps - 1) if steps > 1 else []
            rows = [random.gumbel(kt, (k,), jdtype) for kt in keys]
            noise = jnp.stack(rows + [random.gumbel(key_last, (k,), jdtype)])
        else:
            self.key, sub = random.split(self.key)
            noise = random.gumbel(sub, tuple(shape), jdtype)
        return torch.from_numpy(np.array(noise))


# ---------------------------------------------------------------------------
# level 1
# ---------------------------------------------------------------------------

def _chain_inputs(T_, k, seed_, dtype):
    rng = np.random.default_rng(seed_)
    return (rng.standard_normal(k).astype(dtype),
            rng.standard_normal((T_ - 1, k, k)).astype(dtype))


@pytest.mark.parametrize("T_,k", [(1, 3), (2, 2), (12, 8), (40, 33)])
def test_enum_chain_alphas_match_reference_filter(T_, k):
    a, m = _chain_inputs(T_, k, T_ * k, np.float64)
    with jax.enable_x64(True):
        def fwd(alpha, mat):
            new = jref.enum_contract(alpha, mat)
            return new, new

        _, tail = lax.scan(fwd, jnp.asarray(a), jnp.asarray(m))
        want = np.asarray(jnp.concatenate([jnp.asarray(a)[None], tail]))
    got = ops.enum_chain_alphas(torch.from_numpy(a), torch.from_numpy(m))
    assert got.shape == (T_, k) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def _j_backward_scan(alphas, mats, key):
    """The JAX package's backward sample (src/repro/core/infer/enum.py
    :613-628), the states' indices."""
    key_last, key_rest = random.split(key)
    z_last = random.categorical(key_last, alphas[-1])
    if alphas.shape[0] == 1:
        return z_last[None]
    keys = random.split(key_rest, alphas.shape[0] - 1)

    def back(z_next, inp):
        alpha_t, mat_next, k = inp
        z = random.categorical(k, alpha_t + mat_next[:, z_next])
        return z, z

    _, zs = lax.scan(back, z_last, (alphas[:-1], mats, keys), reverse=True)
    return jnp.concatenate([zs, z_last[None]])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("T_,k", [(1, 4), (2, 2), (12, 8), (40, 33)])
def test_enum_chain_sample_ref_matches_reference_scan(T_, k, dtype):
    a, m = _chain_inputs(T_, k, 7 * T_ + k, dtype)
    alphas = enum_chain_ref(torch.from_numpy(a), torch.from_numpy(m))
    jdtype = {np.float32: jnp.float32, np.float64: jnp.float64}[dtype]
    with jax.enable_x64(dtype == np.float64):
        for seed_ in range(3):
            key = random.PRNGKey(seed_)
            want = _j_backward_scan(jnp.asarray(alphas.numpy()),
                                    jnp.asarray(m), key)
            noise = JaxDraws(key, "chain").gumbel((T_, k), torch.float32
                                                  if dtype == np.float32
                                                  else torch.float64)
            assert noise.dtype == alphas.dtype
            got = enum_chain_sample_ref(alphas, torch.from_numpy(m), noise)
            assert got.dtype == torch.int64 and got.shape == (T_,)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _np_backward(alphas, mats, g):
    """A numpy loop of the backward sample (``np.argmax``: the first
    maximum)."""
    z = [int(np.argmax(g[-1] + alphas[-1]))]
    for t in range(len(alphas) - 2, -1, -1):
        z.append(int(np.argmax(g[t] + (alphas[t] + mats[t][:, z[-1]]))))
    return np.array(z[::-1])


@pytest.mark.parametrize("k", [2, 3, 8, 64])
def test_enum_chain_sample_ref_ties_take_lowest_index(k):
    """Planted ties: equal alphas, noise and matrix columns, in batch rows
    (the plain version over a batch equals each row's loop)."""
    rng = np.random.default_rng(k)
    T_, B = 9, 4
    alphas = rng.integers(-2, 2, (T_, B, k)).astype(np.float32)
    mats = rng.integers(-2, 2, (T_ - 1, B, k, k)).astype(np.float32)
    g = rng.integers(-2, 2, (T_, B, k)).astype(np.float32)
    alphas[:, 0] = 0.0
    g[:, 0] = 0.0
    mats[:, 0] = 0.0      # row 0: every step an all-way tie -> state 0
    got = enum_chain_sample_ref(torch.from_numpy(alphas),
                                torch.from_numpy(mats), torch.from_numpy(g))
    assert got.shape == (T_, B)
    assert (got[:, 0] == 0).all()
    for b in range(B):
        np.testing.assert_array_equal(
            got[:, b].numpy(), _np_backward(alphas[:, b], mats[:, b],
                                            g[:, b]))


def test_enum_chain_sample_is_registered_and_checks_shapes():
    spec = ops.FUSED["enum_chain_sample"]
    assert spec.bit_identical and spec.tol == 0.0 and spec.route == "cuda"
    assert spec.ref is enum_chain_sample_ref
    path, line = spec.replaces.split(":")
    assert "def back" in open(path).read().splitlines()[int(line) - 1]
    assert "enum_chain_sample" in ops.launch_counts()
    with pytest.raises(ValueError, match="takes"):
        ops.enum_chain_sample(torch.zeros(3, 4), torch.zeros(2, 4, 3),
                              torch.zeros(3, 4))
    with pytest.raises(TypeError, match="dtype"):
        ops.enum_chain_sample(torch.zeros(3, 4), torch.zeros(2, 4, 4),
                              torch.zeros(3, 4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# level 2: the reference's draws with its noise injected
# ---------------------------------------------------------------------------

def _count(monkeypatch, name):
    """Route FUSED[name] to a counting plain version; returns the counter."""
    spec = ops.FUSED[name]
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return spec.ref(*args)

    monkeypatch.setitem(ops.FUSED, name, spec._replace(ref=counted))
    return calls


@pytest.mark.parametrize("seed_", [0, 5, 11])
def test_infer_discrete_gmm_replays_reference_draws(seed_, monkeypatch):
    key = random.PRNGKey(seed_)
    with jax.enable_x64(True):
        want = j_infer_discrete(j_substitute(j_gmm, data={"mu": MUS}),
                                key)(jnp.asarray(X))["z"]
        pinned = substitute(gmm, data={"mu": torch.from_numpy(MUS)})
        chain, back = _count(monkeypatch, "enum_chain"), \
            _count(monkeypatch, "enum_chain_sample")
        got = infer_discrete(pinned, JaxDraws(key), device="cpu")(
            torch.from_numpy(X))["z"]
    assert got.dtype == torch.int64 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert chain[0] == 0 and back[0] == 0  # no chain in a mixture


@pytest.mark.parametrize("seed_", [0, 3, 7])
def test_infer_discrete_hmm_replays_reference_draws(seed_, monkeypatch):
    key = random.PRNGKey(seed_)
    with jax.enable_x64(True):
        out = j_infer_discrete(j_substitute(j_hmm, data={"theta": THETA,
                                                         "phi": PHI}),
                               key)(jnp.asarray(W))
        pinned = substitute(hmm, data={"theta": torch.from_numpy(THETA),
                                       "phi": torch.from_numpy(PHI)})
        chain, back = _count(monkeypatch, "enum_chain"), \
            _count(monkeypatch, "enum_chain_sample")
        got = infer_discrete(pinned, JaxDraws(key, chain=True),
                             device="cpu")(torch.from_numpy(W))
    assert set(got) == set(out) == {"chain"}
    assert got["chain"].dtype == torch.int64 and got["chain"].shape == (T,)
    np.testing.assert_array_equal(got["chain"].numpy(),
                                  np.asarray(out["chain"]))
    assert chain[0] == 1 and back[0] == 1  # one filter, one backward sample


def test_infer_discrete_hmm_and_parallel_site_replay_reference():
    """A chain and a parallel site in one model: the chain's source first,
    then the sites' (the reference's fresh_key order)."""
    def j_model(w):
        j_hmm(w)
        c = jpc.sample("c", jdist.Bernoulli(probs=0.3),
                       infer={"enumerate": "parallel"})
        jpc.sample("o", jdist.Normal(2.0 * c, 1.0), obs=0.8)

    def model(w):  # the reference's c and o are float32 under x64 too
        hmm(w)
        c = pc.sample("c", dist.Bernoulli(probs=torch.tensor(0.3)),
                      infer={"enumerate": "parallel"})
        pc.sample("o", dist.Normal(2.0 * c, 1.0), obs=torch.tensor(0.8))

    data = {"theta": THETA, "phi": PHI}
    for seed_ in range(4):
        key = random.PRNGKey(seed_)
        with jax.enable_x64(True):
            want = j_infer_discrete(j_substitute(j_model, data=data),
                                    key)(jnp.asarray(W))
            got = infer_discrete(
                substitute(model, data={k: torch.from_numpy(v)
                                        for k, v in data.items()}),
                JaxDraws(key, chain=True), device="cpu")(torch.from_numpy(W))
        assert set(got) == set(want) == {"chain", "c"}
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


# ---------------------------------------------------------------------------
# level 3, and the entry point's contract
# ---------------------------------------------------------------------------

M = 400


def test_infer_discrete_gmm_marginals_match_exact():
    pinned = substitute(gmm, data={"mu": torch.from_numpy(MUS)})
    x = torch.from_numpy(X)
    zs = torch.stack([infer_discrete(pinned, torch.Generator().manual_seed(i),
                                     device="cpu")(x)["z"]
                      for i in range(M)])
    logits = np.log(WEIGHTS)[None] - 0.5 * (X[:, None] - MUS[None]) ** 2
    exact = np.exp(logits - logits.max(-1, keepdims=True))
    exact /= exact.sum(-1, keepdims=True)
    emp = np.stack([(zs.numpy() == k).mean(0) for k in range(K)], -1)
    assert np.max(np.abs(emp - exact)) < 0.1


def test_infer_discrete_hmm_marginals_match_forward_backward():
    pinned = substitute(hmm, data={"theta": torch.from_numpy(THETA),
                                   "phi": torch.from_numpy(PHI)})
    w = torch.from_numpy(W)
    zs = np.stack([infer_discrete(pinned, i, device="cpu")(w)["chain"]
                   .numpy() for i in range(M)])
    lt, lp = np.log(THETA), np.log(PHI)

    def lse(a, axis):
        mx = a.max(axis, keepdims=True)
        return np.squeeze(mx, axis) + np.log(np.exp(a - mx).sum(axis))

    la = lt[0] + lp[:, W[0]]
    alphas = [la]
    for t in range(1, T):
        la = lse(la[:, None] + lt, 0) + lp[:, W[t]]
        alphas.append(la)
    lb, betas = np.zeros(KH), [np.zeros(KH)]
    for t in range(T - 1, 0, -1):
        lb = lse(lt + lp[:, W[t]][None] + lb[None], 1)
        betas.append(lb)
    post = np.stack([a + b for a, b in zip(alphas, betas[::-1])])
    exact = np.exp(post - post.max(-1, keepdims=True))
    exact /= exact.sum(-1, keepdims=True)
    emp = np.stack([(zs == k).mean(0) for k in range(KH)], -1)
    assert np.max(np.abs(emp - exact)) < 0.1


def test_infer_discrete_run_is_a_function_of_its_generator():
    """A generator's state is copied when ``infer_discrete`` is called:
    every call of ``run`` draws the same, and the caller's generator is
    not advanced; the stray unpinned latent is drawn from it too."""
    def model(x):
        loc = pc.sample("loc", dist.Normal(x.new_zeros(()), x.new_ones(())))
        with pc.plate("data", x.shape[0]):
            z = pc.sample("z", dist.Bernoulli(probs=x.new_full((), 0.5)),
                          infer={"enumerate": "parallel"})
            pc.sample("obs", dist.Normal(loc + 2.0 * z, 1.0), obs=x)

    gen = torch.Generator().manual_seed(4)
    before = gen.get_state()
    run = infer_discrete(model, gen, device="cpu")
    x = torch.from_numpy(X)
    a, b = run(x)["z"], run(x)["z"]
    assert torch.equal(a, b) and torch.equal(gen.get_state(), before)
    assert set(a.unique().tolist()) <= {0.0, 1.0}
    other = infer_discrete(model, torch.Generator().manual_seed(5),
                           device="cpu")
    assert any(not torch.equal(other(x + 0.0 * i)["z"], a)
               for i in range(1, 4))


def test_infer_discrete_warns_and_checks_its_arguments():
    def model():
        pc.sample("x", dist.Normal(0.0, 1.0))

    with pytest.warns(UserWarning, match="no enumerated sites"):
        assert infer_discrete(model, 0, device="cpu")() == {}
    with pytest.raises(ValueError, match="Generator"):
        infer_discrete(model, None, device="cpu")
    with pytest.raises(ValueError, match="draw source"):
        enum(model, first_available_dim=-1, mode="sample")
    if not torch.cuda.is_available():
        with pytest.raises(ReproError, match="cuda"):
            infer_discrete(model, 0)  # the default device is the card


def test_infer_discrete_summary_handles_integer_sites():
    pinned = substitute(gmm, data={"mu": torch.from_numpy(MUS)})
    x = torch.from_numpy(X)
    zs = torch.stack([infer_discrete(pinned, i, device="cpu")(x)["z"]
                      for i in range(40)])
    stats = print_summary({"z": zs.numpy()[None],
                           "mu": np.random.default_rng(0).normal(
                               size=(1, 40))})
    assert set(stats["z"]) >= {"mode", "mode_freq", "n_unique"}
    assert "r_hat" in stats["mu"]
