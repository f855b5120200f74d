"""The paper's benchmark models (Sec. 4) in the port's API: the counterparts
of ``benchmarks/models.py``'s logistic regression, semi-supervised HMM,
fully-latent (enumerated) HMM and SKIM, and ``examples/eight_schools.py``'s
hierarchical model.

Data is made from a seed with numpy, following the JAX package's recipes
(which use ``jax.random``): CoverType-shaped logistic regression with
features ~ N(0, 1), ``true_w ~ N(0, 0.5^2)``, ``y ~ Bernoulli(sigmoid(x @
true_w))``; HMM chains started in state 0 with Dirichlet-drawn transition
and emission matrices; SKIM's features ~ N(0, 1) with ``n_inter`` planted
pairwise interactions.  Each data function also returns the parameters that
generated it (``true_*``).  The model code mirrors the JAX models line for
line, but for the semi-supervised HMM's forward pass, which multiplies the
same steps out as a tree (see ``hmm_model``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import core as pc
from ..core import dist


def covtype_data(seed=0, n=581_012, d=54):
    """numpy float32 ``{"x": (n, d), "y": (n,), "true_w": (d,)}``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    true_w = (rng.standard_normal(d, dtype=np.float32) * np.float32(0.5))
    logits = x @ true_w
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    y = (rng.random(n) < p).astype(np.float32)
    return {"x": x, "y": y, "true_w": true_w}


def logreg_model(x, y=None):
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y)


def logreg_model_glm(x, y=None):
    """Same model, opted into the fused GLM potential: the likelihood value
    and its gradient come from one ``ops.glm_potential_grad`` pass over x
    (verified affine at setup; falls back to the plain potential if not)."""
    d = x.shape[-1]
    w = pc.sample("w", dist.Normal(x.new_zeros(d), x.new_ones(d)).to_event(1))
    return pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
                     infer={"potential": "glm"})


def svi_logreg_model(n, subsample_size=None):
    """``benchmarks/svi_minibatch.py``'s logistic regression for SVI: slope
    ``m`` (d,) and intercept ``b``, the likelihood in a plate of the ``n``
    rows that draws a minibatch of ``subsample_size`` rows per step (the
    full data when ``None``).  Returns ``model(x, y=None)``."""
    def model(x, y=None):
        d = x.shape[-1]
        m = pc.sample("m", dist.Normal(x.new_zeros(()), x.new_ones(()))
                      .expand((d,)).to_event(1))
        b = pc.sample("b", dist.Normal(x.new_zeros(()), x.new_ones(())))
        with pc.plate("N", n, subsample_size=subsample_size):
            xb = pc.subsample(x, event_dim=1)
            yb = pc.subsample(y, event_dim=0) if y is not None else None
            pc.sample("y", dist.Bernoulli(logits=xb @ m + b), obs=yb)
    return model


# ---------------------------------------------------------------------------
# HMMs
# ---------------------------------------------------------------------------

def _hmm_chain(rng, theta, phi, T):
    """States z_1..z_T (from z_0 = 0) and emissions w_0..w_{T-1}, where
    w_t is emitted by z_{t+1}: the JAX package's sampling loop."""
    K, V = phi.shape
    z, zs, ws = 0, [], []
    for _ in range(T):
        z = rng.choice(K, p=theta[z])
        zs.append(z)
        ws.append(rng.choice(V, p=phi[z]))
    return np.asarray(zs, np.int64), np.asarray(ws, np.int64)


def hmm_data(seed=0, T=600, T_sup=100, K=3, V=10):
    """The paper's semi-supervised HMM (Stan manual sec. 2.6): K = 3 states,
    V = 10 symbols, T = 600 steps of which the first T_sup have observed
    states.  ``theta ~ Dirichlet(2)``, ``phi ~ Dirichlet(1)`` per row."""
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.full(K, 2.0), size=K)
    phi = rng.dirichlet(np.ones(V), size=K)
    zs, ws = _hmm_chain(rng, theta, phi, T)
    return {"w": ws, "z_sup": zs[:T_sup], "T_sup": T_sup, "K": K, "V": V,
            "true_theta": theta.astype(np.float32),
            "true_phi": phi.astype(np.float32)}


def hmm_model(data):
    K, V, T_sup = data["K"], data["V"], data["T_sup"]
    w = data["w"]
    theta = pc.sample("theta", dist.Dirichlet(
        torch.full((K, K), 2.0, device=w.device)).to_event(1))
    phi = pc.sample("phi", dist.Dirichlet(
        torch.full((K, V), 1.0, device=w.device)).to_event(1))
    # supervised prefix: observed states
    z_sup = data["z_sup"]
    with pc.plate("sup", T_sup - 1):
        pc.sample("z_trans", dist.Categorical(probs=theta[z_sup[:-1]]),
                  obs=z_sup[1:])
        pc.sample("w_sup", dist.Categorical(probs=phi[z_sup[:-1]]),
                  obs=w[:T_sup - 1])
    # unsupervised suffix: marginalize latent states with a forward pass
    log_theta = torch.log(theta)
    log_phi = torch.log(phi)
    # (indices as length-1 slices and one gather of the emission columns:
    # indexing with a 0-d device tensor would read it back to the host)
    init = log_theta[z_sup[-1:]][0] + log_phi[:, w[T_sup - 1:T_sup]][:, 0]
    emissions = log_phi[:, w[T_sup:]].T       # row t: log_phi[:, w[T_sup + t]]
    # The JAX model's lax.scan steps log_alpha <- logsumexp(log_alpha[:, None]
    # + log_theta, 0) + emit_t.  Step t is the log-space product with
    # log_theta + emit_t[None, :], so the chain of T - T_sup steps is
    # multiplied out as a balanced tree: ceil(log2 n) rounds of batched
    # products rather than n sequential ones (eager PyTorch pays per launch).
    mats = log_theta + emissions[:, None, :]  # (n, K, K)
    while mats.shape[0] > 1:
        n = mats.shape[0]
        pairs = mats[:n - n % 2].reshape(n // 2, 2, K, K)
        prod = torch.logsumexp(pairs[:, 0, :, :, None]
                               + pairs[:, 1, None, :, :], dim=2)
        mats = torch.cat([prod, mats[n - 1:]]) if n % 2 else prod
    log_alpha = init
    if mats.shape[0]:
        log_alpha = torch.logsumexp(log_alpha[:, None] + mats[0], dim=0)
    pc.sample("marginal", dist.Delta(
        log_alpha.new_zeros(()), log_density=torch.logsumexp(log_alpha, 0)),
        obs=log_alpha.new_zeros(()))


def enum_hmm_data(K, seed=0, T=120, V=16):
    """The fully-latent HMM's data: ``theta ~ Dirichlet(0.5)``, ``phi ~
    Dirichlet(0.3)`` per row, T emissions from a chain started in state 0."""
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.full(K, 0.5), size=K)
    phi = rng.dirichlet(np.full(V, 0.3), size=K)
    _, ws = _hmm_chain(rng, theta, phi, T)
    return {"w": ws, "K": K, "V": V, "true_theta": theta.astype(np.float32),
            "true_phi": phi.astype(np.float32)}


def enum_hmm_model(data):
    """No supervision and no manual marginalization: the hidden states are
    summed out by ``markov`` at O(T K^2) per potential evaluation, through
    ``ops.enum_chain`` (the T-1 contractions in one call)."""
    from ..core.infer import markov
    K, V, w = data["K"], data["V"], data["w"]
    theta = pc.sample("theta", dist.Dirichlet(
        torch.ones((K, K), device=w.device)).to_event(1))
    phi = pc.sample("phi", dist.Dirichlet(
        torch.ones((K, V), device=w.device)).to_event(1))

    def step(z_prev, w_t):
        z = pc.sample("z", dist.Categorical(probs=theta[z_prev]))
        pc.sample("w", dist.Categorical(probs=phi[z]), obs=w_t)
        return z

    markov(step, 0, w)


# ---------------------------------------------------------------------------
# SKIM — sparse kernel interaction model (Agrawal et al. 2019)
# ---------------------------------------------------------------------------

def skim_data(p, seed=0, n=200, n_inter=3):
    """numpy float32 ``{"x": (n, p), "y": (n,), "true_pairs": (n_inter,
    2)}``: features ~ N(0, 1); ``n_inter`` disjoint pairs of dimensions, the
    first of each pair with a main effect of 1 and each pair's product an
    interaction of weight 2; noise sd 0.1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    pairs = rng.choice(p, size=(n_inter, 2), replace=False)
    beta = np.zeros(p, np.float32)
    beta[pairs[:, 0]] = 1.0
    inter = np.prod(x[:, pairs], axis=-1) @ np.ones(n_inter, np.float32)
    y = x @ beta + 2.0 * inter \
        + np.float32(0.1) * rng.standard_normal(n).astype(np.float32)
    return {"x": x, "y": y.astype(np.float32), "true_pairs": pairs}


def skim_model(x, y=None):
    """Kernel-trick formulation: per-dimension sparsity scales kappa with a
    horseshoe-like prior; interactions live in the quadratic kernel."""
    n, p = x.shape
    lam = pc.sample("lambda", dist.HalfCauchy(x.new_ones(p)).to_event(1))
    tau = pc.sample("tau", dist.HalfCauchy(x.new_ones(())))
    eta1 = pc.sample("eta1", dist.HalfCauchy(x.new_ones(())))
    c2 = pc.sample("c2", dist.InverseGamma(x.new_full((), 2.0), 2.0))
    sigma = pc.sample("sigma", dist.HalfNormal(x.new_ones(())))
    lam2 = lam ** 2
    kappa = torch.sqrt(eta1 ** 2 * c2 * lam2 / (eta1 ** 2 + c2 * lam2))
    xk = x * kappa * tau
    # quadratic kernel captures main + pairwise effects (kernel trick)
    k1 = xk @ xk.T
    K = (k1 + 1.0) ** 2 - 1.0
    K = K + (sigma ** 2 + 1e-4) * torch.eye(n, dtype=x.dtype, device=x.device)
    pc.sample("y", dist.MultivariateNormal(x.new_zeros(n),
                                           covariance_matrix=K), obs=y)


# ---------------------------------------------------------------------------
# eight schools (Rubin 1981): the hierarchical funnel of the README
# ---------------------------------------------------------------------------

def eight_schools_data():
    """numpy float32 ``{"y": (8,), "sigma": (8,)}``: the schools' estimated
    effects and their standard errors."""
    return {"y": np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0],
                          np.float32),
            "sigma": np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0,
                               18.0], np.float32)}


def eight_schools(sigma, y=None):
    """The centered model of ``examples/eight_schools.py``, with the
    standard errors an argument (so they lie on the sampler's device);
    ``reparam(eight_schools, config={"theta": LocScaleReparam(0.0)})`` is
    its non-centered form."""
    mu = pc.sample("mu", dist.Normal(sigma.new_zeros(()), 5.0))
    tau = pc.sample("tau", dist.HalfCauchy(sigma.new_full((), 5.0)))
    with pc.plate("J", sigma.shape[0]):
        theta = pc.sample("theta", dist.Normal(mu, tau))
        pc.sample("obs", dist.Normal(theta, sigma), obs=y)
    return theta
