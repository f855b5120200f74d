"""MCMC diagnostics: effective sample size (Geyer initial monotone sequence),
split Gelman-Rubin R-hat, HPDI, and summary printing.

Pure numpy, kept as this package's own copy of the JAX package's module (the
port imports nothing of ``repro``); callers pass host arrays."""
from __future__ import annotations

import numpy as np


def _autocovariance(x):
    """Autocovariance along axis 0 via FFT. x: (n, ...)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    x = x - x.mean(0, keepdims=True)
    m = 1
    while m < 2 * n:
        m *= 2
    f = np.fft.rfft(x, n=m, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=0)[:n]
    return acov / n


def effective_sample_size(x):
    """ESS of ``x`` with shape (num_chains, num_samples, ...)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape[:2]
    acov = np.stack([_autocovariance(x[i]) for i in range(c)], 0)  # (c,n,...)
    chain_var = acov[:, 0]                       # biased variance per chain
    mean_var = chain_var.mean(0)                 # W
    var_plus = mean_var * (n - 1) / n
    if c > 1:
        var_plus = var_plus + x.mean(1).var(0, ddof=1)  # + B/n
    rho = 1.0 - (mean_var - acov.mean(0)) / np.where(var_plus == 0, 1.0,
                                                     var_plus)
    rho[0] = 1.0
    # Geyer: sums of adjacent pairs, initial positive + monotone decreasing
    t_max = (n - 1) // 2
    rho_even = rho[0:2 * t_max:2]
    rho_odd = rho[1:2 * t_max:2]
    pair = rho_even + rho_odd                    # (t_max, ...)
    pair = np.where(pair > 0, pair, 0.0)
    # enforce monotone non-increasing
    pair = np.minimum.accumulate(pair, axis=0)
    # zero out everything after the first non-positive pair
    positive = pair > 0
    keep = np.logical_and.accumulate(positive, axis=0)
    tau = -1.0 + 2.0 * (pair * keep).sum(0)
    ess = c * n / np.maximum(tau, 1.0 / (c * n))
    return ess


def gelman_rubin(x):
    """Split R-hat; x: (num_chains, num_samples, ...)."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape[:2]
    half = n // 2
    splits = np.concatenate([x[:, :half], x[:, half:2 * half]], 0)
    m, n2 = splits.shape[:2]
    chain_mean = splits.mean(1)
    chain_var = splits.var(1, ddof=1)
    W = chain_var.mean(0)
    B = n2 * chain_mean.var(0, ddof=1)
    var_plus = (n2 - 1) / n2 * W + B / n2
    return np.sqrt(var_plus / np.where(W == 0, 1.0, W))


def hpdi(x, prob=0.9, axis=0):
    x = np.sort(np.asarray(x), axis=axis)
    n = x.shape[axis]
    mass = int(np.floor(prob * n))
    starts = np.take(x, np.arange(n - mass), axis=axis)
    ends = np.take(x, np.arange(mass, n), axis=axis)
    widths = ends - starts
    best = np.argmin(widths, axis=axis)
    lo = np.take_along_axis(starts, np.expand_dims(best, axis), axis=axis)
    hi = np.take_along_axis(ends, np.expand_dims(best, axis), axis=axis)
    return np.squeeze(lo, axis), np.squeeze(hi, axis)


def _discrete_summary(flat):
    """Per-element mode / mode frequency / support size for integer-dtype
    draws (e.g. ``infer_discrete`` output): continuous moments and
    R-hat/ESS are meaningless for unordered discrete states."""
    n_elem = flat.shape[-1]
    modes = np.empty(n_elem, flat.dtype)
    mode_freq = np.empty(n_elem)
    n_unique = np.empty(n_elem, np.int64)
    for i in range(n_elem):
        vals, counts = np.unique(flat[..., i], return_counts=True)
        j = int(np.argmax(counts))
        modes[i] = vals[j]
        mode_freq[i] = counts[j] / flat[..., i].size
        n_unique[i] = len(vals)
    return {"mode": modes, "mode_freq": mode_freq, "n_unique": n_unique,
            "mean": flat.mean((0, 1))}


def summary(samples_by_chain, prob=0.9):
    """Dict of per-site statistics; values shaped (chains, samples, ...).

    Float sites get the usual moments, the ``prob``-mass HPDI
    (``hpdi_lo`` / ``hpdi_hi``), split R-hat and ESS.  Integer or boolean
    sites (discrete draws, as produced by ``infer_discrete``) instead
    report ``mode`` / ``mode_freq`` / ``n_unique`` (+ ``mean``) — counts of
    states, not chain-mixing statistics.

    ESS/R-hat are computed in one vectorized call over the trailing element
    axis rather than per-element Python loops; results match the looped path
    to float64 round-off (batched FFTs and reductions associate differently,
    so parity is ~1e-12 relative, not bitwise).
    """
    out = {}
    for name, x in samples_by_chain.items():
        x = np.asarray(x)
        flat = x.reshape(x.shape[0], x.shape[1], -1)
        if np.issubdtype(flat.dtype, np.integer) or flat.dtype == np.bool_:
            stats = _discrete_summary(flat)
            out[name] = {k: v.reshape(x.shape[2:]) for k, v in stats.items()}
            continue
        lo, hi = hpdi(flat.reshape(-1, flat.shape[-1]), prob=prob, axis=0)
        stats = {
            "mean": flat.mean((0, 1)),
            "std": flat.std((0, 1)),
            "median": np.median(flat, (0, 1)),
            "hpdi_lo": np.atleast_1d(lo),
            "hpdi_hi": np.atleast_1d(hi),
            "n_eff": np.atleast_1d(effective_sample_size(flat)),
            "r_hat": np.atleast_1d(gelman_rubin(flat)),
        }
        out[name] = {k: v.reshape(x.shape[2:]) for k, v in stats.items()}
    return out


def print_summary(samples_by_chain, prob=0.9):
    stats = summary(samples_by_chain, prob)
    lo_lab, hi_lab = f"{prob * 100:g}%<", f"{prob * 100:g}%>"
    header = f"{'site':>20} {'mean':>10} {'std':>10} {'median':>10} " \
             f"{lo_lab:>10} {hi_lab:>10} {'n_eff':>10} {'r_hat':>8}"
    print(header)
    for name, s in stats.items():
        if "mode" in s:  # discrete (integer-dtype) site
            mode = np.atleast_1d(s["mode"]).ravel()
            freq = np.atleast_1d(s["mode_freq"]).ravel()
            nu = np.atleast_1d(s["n_unique"]).ravel()
            for i in range(mode.size):
                label = name if mode.size == 1 else f"{name}[{i}]"
                print(f"{label:>20} mode={mode[i]:<6d} "
                      f"freq={freq[i]:<7.3f} n_unique={nu[i]:<4d} (discrete)")
            continue
        mean = np.atleast_1d(s["mean"]).ravel()
        std = np.atleast_1d(s["std"]).ravel()
        med = np.atleast_1d(s["median"]).ravel()
        lo = np.atleast_1d(s["hpdi_lo"]).ravel()
        hi = np.atleast_1d(s["hpdi_hi"]).ravel()
        ne = np.atleast_1d(s["n_eff"]).ravel()
        rh = np.atleast_1d(s["r_hat"]).ravel()
        for i in range(mean.size):
            label = name if mean.size == 1 else f"{name}[{i}]"
            print(f"{label:>20} {mean[i]:>10.4f} {std[i]:>10.4f} "
                  f"{med[i]:>10.4f} {lo[i]:>10.4f} {hi[i]:>10.4f} "
                  f"{ne[i]:>10.1f} {rh[i]:>8.3f}")
    return stats
