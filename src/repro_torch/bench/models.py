"""The paper's benchmark models (Sec. 4) in the port's API: the counterparts
of ``benchmarks/models.py``'s logistic regression, semi-supervised HMM and
fully-latent (enumerated) HMM.

Data is made from a seed with numpy, following the JAX package's recipes
(which use ``jax.random``): CoverType-shaped logistic regression with
features ~ N(0, 1), ``true_w ~ N(0, 0.5^2)``, ``y ~ Bernoulli(sigmoid(x @
true_w))``; HMM chains started in state 0 with Dirichlet-drawn transition
and emission matrices.  Each data function also returns the parameters that
generated it (``true_*``).  The model code mirrors the JAX models line for
line.  SKIM waits for its slice.
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
    log_alpha = init
    for emit in emissions.unbind(0):          # the JAX model's lax.scan
        log_alpha = torch.logsumexp(log_alpha[:, None] + log_theta, dim=0)
        log_alpha = log_alpha + emit
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
    ``ops.enum_contract``."""
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
