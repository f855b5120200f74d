"""HMC/NUTS numerical core.

The centerpiece is :func:`iterative_build_subtree` — the paper's Algorithm 2:
the *iterative* form of the recursive BuildTree, which keeps O(log N)
memory through bit-count-indexed momentum checkpoints.

In the JAX package the whole trajectory is one ``lax.while_loop``.  Here the
loops are Python loops: vectors (position, momentum, gradient, checkpoints)
stay on the device, and the scalars that steer the tree (energies, U-turn
dot products) come back to the host once per leapfrog, in one read
(:class:`HostReads` counts them), with a second read per doubling for the
merged tree's U-turn check.  Between two potential evaluations of a
subtree everything else is one ``ops.nuts_leaf`` launch, and the merged
tree's check one ``ops.nuts_turning`` launch.  The tree's scalar state is
kept on the host in float32, so the ``lax.cond``/``jnp.where`` selections
of the JAX package become Python ``if``s over references, with the same
semantics.

:func:`build_tree_batch` is the lockstep tree of C chains (the JAX
package's ``vmap`` of :func:`build_tree`): the vectors are (C, D) on the
device, each chain's steering scalars host (C,) float32 arrays, a doubling
runs while any chain still grows, and a lockstep leaf is one potential
evaluation of the live chains, one ``ops.nuts_leaf_batch`` launch and one
read for all of them; the host's per-chain decisions (directions,
selections) reach the device as (C,) masks copied without a sync.  A dense
(D, D) inverse mass matrix takes the plain leaf (:func:`nuts_leaf_dense`,
``m_inv @ r``), as the JAX package fuses only the diagonal path.

Randomness comes from a *draw source* (:class:`GeneratorDraws` by default)
so that a test can replay another implementation's draws: momentum normals,
direction bits, and the transition uniforms (and, for the ensemble samplers,
their ``(C, D)`` momenta and noise and ``(C,)`` uniforms).

The cross-chain helpers at the end serve the ensemble samplers (ChEES,
MALA/RWM): the pairwise ``chain_sum`` fold (``kernels/leapfrog.py``, where
the plain versions of the ensembles' fused steps need it), the pooled
Welford accumulators, the chain-batched potential gradient and the ``(C,
D)`` trajectory with merged interior kicks (ChEES runs its own through
``graphs.EnsembleTrajectory``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...kernels import ops
from ...kernels.leapfrog import (chain_sum, halfstep_chains_ref,
                                 nuts_leaf_batch_ref, nuts_turning_batch_ref,
                                 welford_merge, welford_moments)

_F32 = np.float32


class HostReads:
    """Every device->host read the sampler makes, counted.  On a card each
    read waits for the device: the count is the number of host syncs."""

    def __init__(self):
        self.count = 0

    def read(self, tensor) -> list:
        self.count += 1
        return tensor.tolist()

    def fetch(self, tensor) -> np.ndarray:
        """``tensor`` copied to a host numpy array: one read."""
        self.count += 1
        return tensor.detach().cpu().numpy()

    def sync(self, device) -> None:
        """Wait for the card's work (a no-op on the CPU): one sync."""
        self.count += 1
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


class GeneratorDraws:
    """The sampler's random draws, all from one CPU ``torch.Generator`` (so
    a seed gives the same chain on every device).  Vectors are moved to the
    device by the caller."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def momentum(self, d, dtype):
        """Standard normal (d,) draw; scaled by the mass matrix outside."""
        return torch.randn(d, generator=self.generator, dtype=dtype)

    def init_uniform(self, d, dtype):
        return torch.rand(d, generator=self.generator, dtype=dtype)

    def direction(self) -> bool:
        return bool(torch.randint(2, (), generator=self.generator))

    def _uniform(self) -> float:
        return float(torch.rand((), generator=self.generator))

    leaf_uniform = merge_uniform = accept_uniform = _uniform

    # the ensemble samplers' draws: one shared source moves every chain
    def momentum_batch(self, c, d, dtype):
        """Standard normal (C, D) momenta; scaled by the mass outside."""
        return torch.randn((c, d), generator=self.generator, dtype=dtype)

    noise = momentum_batch  # MALA/RWM proposal noise, (C, D)

    def accept_uniforms(self, c, dtype):
        """(C,) uniforms of the chains' Metropolis tests."""
        return torch.rand(c, generator=self.generator, dtype=dtype)

    # the discrete posterior's draws (``infer_discrete``)
    def gumbel(self, shape, dtype):
        """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform on
        ``[tiny, 1)``: a categorical draw is ``argmax(gumbel + logits)``."""
        u = torch.rand(shape, generator=self.generator, dtype=dtype)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))

    def fresh(self) -> "GeneratorDraws":
        """A new source seeded from this one (the JAX package's key split)."""
        return split_draws(self.generator, 1)[0]


def split_draws(generator: torch.Generator, count: int):
    """``count`` independent draw sources seeded from ``generator``: the
    chains' sources of an entry point that gets one generator."""
    seeds = torch.randint(2 ** 62, (count,), generator=generator).tolist()
    return [GeneratorDraws(torch.Generator().manual_seed(int(s)))
            for s in seeds]


def to_device(t, device):
    """Host -> device copy without a sync (pinned, non-blocking on a card)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


# ---------------------------------------------------------------------------
# integrator
# ---------------------------------------------------------------------------

class IntegratorState(NamedTuple):
    z: torch.Tensor              # position, flat (D,)
    r: torch.Tensor              # momentum, flat (D,)
    potential_energy: torch.Tensor
    z_grad: torch.Tensor         # dU/dz, flat (D,)


def is_dense(inverse_mass_matrix, r) -> bool:
    """Whether ``inverse_mass_matrix`` is a dense (D, D) matrix for the flat
    (D,) momentum ``r`` (else a diagonal, or a chain batch of diagonals)."""
    return inverse_mass_matrix.dim() == r.dim() + 1


def velocity(inverse_mass_matrix, r):
    """``m_inv r``: elementwise for a diagonal, ``m_inv @ r`` for a dense
    (D, D) matrix."""
    if is_dense(inverse_mass_matrix, r):
        return torch.matmul(inverse_mass_matrix, r)
    return inverse_mass_matrix * r


def kinetic_energy(inverse_mass_matrix, r):
    """``0.5 r . (m_inv r)``; a ``(C, D)`` ensemble with a diagonal gives
    ``(C,)``."""
    if r.dim() == 1:
        return 0.5 * torch.dot(r, velocity(inverse_mass_matrix, r))
    return 0.5 * torch.sum(r * (inverse_mass_matrix * r), -1)


def momentum_sample(eps, inverse_mass_matrix):
    """r ~ N(0, M) with M = imm^{-1}, from a standard normal ``eps``; for a
    dense imm = L L^T, r = L^{-T} eps."""
    if not is_dense(inverse_mass_matrix, eps):
        return eps / torch.sqrt(inverse_mass_matrix)
    chol = torch.linalg.cholesky(inverse_mass_matrix)
    return torch.linalg.solve_triangular(chol.mT, eps.unsqueeze(-1),
                                         upper=True).squeeze(-1)


def value_and_grad(potential_fn: Callable):
    """``z -> (potential, dpotential/dz)`` through ``torch.autograd``."""
    def pe_and_grad(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            pe = potential_fn(z)
            (grad,) = torch.autograd.grad(pe, z)
        return pe.detach(), grad

    return pe_and_grad


def halfstep(z, r, grad, inverse_mass_matrix, step_size):
    """Momentum half-kick and position drift: ``ops.leapfrog_halfstep`` for
    a diagonal mass, the plain two-pass form with ``m_inv @ r`` for a dense
    one (the JAX package fuses only the diagonal path)."""
    if not is_dense(inverse_mass_matrix, r):
        return ops.leapfrog_halfstep(z, r, grad, inverse_mass_matrix,
                                     step_size)
    r = r - 0.5 * step_size * grad
    return z + step_size * velocity(inverse_mass_matrix, r), r


def velocity_verlet(potential_fn: Callable):
    """Single leapfrog step closure.  The memory-bound half of the step —
    momentum half-kick and position drift — goes through :func:`halfstep`
    (the fused ``ops.leapfrog_halfstep`` for a diagonal mass); ``step_size``
    may be a device scalar, which the kernel reads from device memory."""
    pe_and_grad = value_and_grad(potential_fn)

    def init(z):
        return pe_and_grad(z)

    def update(step_size, inverse_mass_matrix, state: IntegratorState):
        z, r = halfstep(state.z, state.r, state.z_grad, inverse_mass_matrix,
                        step_size)
        pe, z_grad = pe_and_grad(z)
        r = r - 0.5 * step_size * z_grad
        return IntegratorState(z, r, pe, z_grad)

    return init, update


# ---------------------------------------------------------------------------
# dual averaging (Nesterov 2009 / Hoffman & Gelman 2014), host float32
# ---------------------------------------------------------------------------

class DAState(NamedTuple):
    x: np.float32        # log step size
    x_avg: np.float32
    g_avg: np.float32
    t: int
    prox_center: np.float32


def dual_averaging_init(x0):
    x0 = _F32(x0)
    return DAState(x0, _F32(0), _F32(0), 0, x0 + _F32(math.log(10.0)))


def dual_averaging_update(state: DAState, g, t0=10, kappa=0.75, gamma=0.05):
    x, x_avg, g_avg, t, prox_center = state
    t = t + 1
    tf = _F32(t)
    g_avg = (_F32(1) - _F32(1) / (tf + _F32(t0))) * g_avg \
        + _F32(g) / (tf + _F32(t0))
    x = prox_center - np.sqrt(tf) / _F32(gamma) * g_avg
    weight = tf ** _F32(-kappa)
    x_avg = (_F32(1) - weight) * x_avg + weight * x
    return DAState(_F32(x), _F32(x_avg), _F32(g_avg), t, prox_center)


# ---------------------------------------------------------------------------
# Welford online (co)variance
# ---------------------------------------------------------------------------

class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor             # (D,) diagonal or (D, D) dense
    n: int


def welford_init(size, dtype=torch.float32, device="cpu", diagonal=True):
    mean = torch.zeros(size, dtype=dtype, device=device)
    m2 = torch.zeros(size if diagonal else (size, size), dtype=dtype,
                     device=device)
    return WelfordState(mean, m2, 0)


def welford_update(state: WelfordState, x):
    """Fold ``x`` in; ``x`` and ``mean`` may lead with a chain axis that
    shares ``n`` (every row is the same arithmetic as alone)."""
    mean, m2, n = state
    n = n + 1
    delta_pre = x - mean
    mean = mean + delta_pre / n
    delta_post = x - mean
    if m2.dim() == mean.dim():
        return WelfordState(mean, m2 + delta_pre * delta_post, n)
    # dense: outer(delta_post, delta_pre)
    return WelfordState(mean, m2 + delta_post.unsqueeze(-1)
                        * delta_pre.unsqueeze(-2), n)


def welford_covariance(state: WelfordState, regularize=True):
    """The (shrunk) covariance estimate, diagonal or dense as ``m2`` is;
    ``m2`` may lead with a chain axis that shares ``n``."""
    mean, m2, n = state
    nf = float(max(n, 2))
    cov = m2 / (nf - 1)
    if regularize:  # Stan's shrinkage toward identity
        scaled = (nf / (nf + 5.0)) * cov
        shrink = 1e-3 * (5.0 / (nf + 5.0))
        if m2.dim() == mean.dim():
            cov = scaled + shrink
        else:
            cov = scaled + shrink * torch.eye(
                m2.shape[-1], dtype=m2.dtype, device=m2.device)
    return cov


# ---------------------------------------------------------------------------
# step-size search
# ---------------------------------------------------------------------------

def find_reasonable_step_size(potential_fn, inverse_mass_matrix, z, pe,
                              z_grad, draws, reads, init_step_size=1.0,
                              target=0.8, max_iters=64):
    """Double/halve the step size until the one-step accept prob crosses
    ``target`` from the chosen direction.  Returns a host float32."""
    _, vv_update = velocity_verlet(potential_fn)

    def accept_log_prob(step_size, r):
        ke = kinetic_energy(inverse_mass_matrix, r)
        eps = torch.full((), float(step_size), dtype=z.dtype, device=z.device)
        nxt = vv_update(eps, inverse_mass_matrix,
                        IntegratorState(z, r, pe, z_grad))
        ke_new = kinetic_energy(inverse_mass_matrix, nxt.r)
        vals = reads.read(torch.stack([pe, ke, nxt.potential_energy, ke_new]))
        energy_cur = _F32(vals[0]) + _F32(vals[1])
        energy_new = _F32(vals[2]) + _F32(vals[3])
        if not np.isfinite(energy_new):
            return -math.inf
        return min(float(energy_cur - energy_new), 0.0)

    log_target = math.log(target)
    r0 = momentum_sample(to_device(draws.momentum(z.numel(), z.dtype),
                                   z.device), inverse_mass_matrix)
    step_size = _F32(init_step_size)
    alp = accept_log_prob(step_size, r0)
    direction = 1.0 if alp > log_target else -1.0
    for _ in range(max_iters):
        crossed = alp <= log_target if direction > 0 else alp > log_target
        if crossed or not 1e-10 < step_size < 1e10:
            break
        step_size = _F32(step_size * _F32(2.0 ** direction))
        alp = accept_log_prob(step_size, r0)
    return step_size


# ---------------------------------------------------------------------------
# adaptation schedule (Stan-style windows)
# ---------------------------------------------------------------------------

def build_adaptation_schedule(num_steps):
    """Returns a list of (start, end) inclusive windows. First and last are
    fast (step-size only) buffers; middle windows adapt the mass matrix with
    doubling lengths."""
    if num_steps < 20:
        return [(0, num_steps - 1)] if num_steps > 0 else []
    init_buffer, term_buffer, base_window = 75, 50, 25
    if init_buffer + base_window + term_buffer > num_steps:
        init_buffer = int(0.15 * num_steps)
        term_buffer = int(0.1 * num_steps)
        base_window = num_steps - init_buffer - term_buffer
    schedule = [(0, init_buffer - 1)]
    end = num_steps - term_buffer - 1
    start, size = init_buffer, base_window
    while start + size - 1 < end:
        nxt = start + size
        if nxt + 2 * size - 1 > end:  # absorb remainder into this window
            schedule.append((start, end))
            start = end + 1
            break
        schedule.append((start, nxt - 1))
        start, size = nxt, 2 * size
    if start <= end:
        schedule.append((start, end))
    schedule.append((num_steps - term_buffer, num_steps - 1))
    return schedule


def window_predicates(schedule):
    """Returns ``(in_middle_window, window_end_is_middle)``: int -> bool
    predicates over the window schedule."""
    middle = schedule[1:-1] if len(schedule) > 2 else []

    def in_middle_window(t):
        return any(s <= t <= e for s, e in middle)

    def window_end_is_middle(t):
        return any(t == e for _, e in middle)

    return in_middle_window, window_end_is_middle


# ---------------------------------------------------------------------------
# iterative NUTS tree building (paper Algorithm 2)
# ---------------------------------------------------------------------------

class TreeState(NamedTuple):
    z_left: torch.Tensor
    r_left: torch.Tensor
    z_left_grad: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    z_right_grad: torch.Tensor
    z_proposal: torch.Tensor
    z_proposal_pe: torch.Tensor
    z_proposal_grad: torch.Tensor
    z_proposal_energy: np.float32
    depth: int
    weight: np.float32           # log sum of exp(-energy) over leaves
    r_sum: torch.Tensor          # sum of momenta over all leaves
    turning: bool
    diverging: bool
    sum_accept_probs: np.float32
    num_proposals: int


def _bit_count(n: int) -> int:
    return bin(n).count("1")


def _leaf_idx_to_ckpt_idxs(n: int):
    """For odd leaf ``n``, the checkpoint index range [idx_min, idx_max]
    holding the left ends of every balanced subtree whose rightmost node is
    ``n`` (trailing-1s masking; paper App. A)."""
    idx_max = _bit_count(n - 1)
    trailing_ones = _bit_count(n ^ (n + 1)) - 1
    return idx_max - trailing_ones + 1, idx_max


def turning_dots_dense(inverse_mass_matrix, r_left, r_right, r_sum):
    """The two generalized U-turn dots with a dense (D, D) ``m_inv`` (plain
    torch, as the JAX package's dense path): ``v . r_mid`` with ``v = m_inv
    r``; ``r_left`` may carry a leading batch of checkpoints."""
    r_mid = r_sum - 0.5 * (r_left + r_right)
    v_left = torch.matmul(r_left, inverse_mass_matrix.mT)
    v_right = torch.matmul(inverse_mass_matrix, r_right)
    return torch.stack([torch.sum(v_left * r_mid, -1),
                        torch.sum(v_right * r_mid, -1)])


def turning_dots(inverse_mass_matrix, r_left, r_right, r_sum):
    """The merged tree's two U-turn dots: ``ops.nuts_turning`` for a
    diagonal mass, :func:`turning_dots_dense` for a dense one."""
    if is_dense(inverse_mass_matrix, r_right):
        return turning_dots_dense(inverse_mass_matrix, r_left, r_right, r_sum)
    return ops.nuts_turning(inverse_mass_matrix, r_left, r_right, r_sum)


def _is_turning(inverse_mass_matrix, r_left, r_right, r_sum, reads) -> bool:
    dots = reads.read(turning_dots(inverse_mass_matrix, r_left, r_right,
                                   r_sum))
    return dots[0] <= 0 or dots[1] <= 0


def nuts_leaf_dense(r_half, z, grad, pe, m_inv, eps, r_sum, r_ckpts,
                    r_sum_ckpts, ckpt_i=None, idx_min=0, idx_max=-1):
    """``ops.nuts_leaf`` with a dense (D, D) ``m_inv``, in plain torch with
    ``m_inv @ r`` (the JAX package's dense path runs outside any kernel):
    the same arguments, results and order as ``nuts_leaf_ref``."""
    r = r_half - 0.5 * eps * grad
    ke = 0.5 * torch.dot(r, velocity(m_inv, r))
    r_sum_through = r if r_sum is None else r_sum + r
    parts = [pe.reshape(1), ke.reshape(1)]
    if ckpt_i is not None:
        r_ckpts[ckpt_i] = r
        r_sum_ckpts[ckpt_i] = r_sum_through
    elif idx_min <= idx_max:
        rc = r_ckpts[idx_min:idx_max + 1]
        subtree_r_sum = r_sum_through - r_sum_ckpts[idx_min:idx_max + 1] + rc
        parts.append(turning_dots_dense(m_inv, rc, r, subtree_r_sum)
                     .reshape(-1))
    z_next, r_half_next = halfstep(z, r, grad, m_inv, eps)
    return r, r_sum_through, torch.cat(parts), z_next, r_half_next


def nuts_leaf(r_half, z, grad, pe, m_inv, eps, r_sum, r_ckpts, r_sum_ckpts,
              ckpt_i=None, idx_min=0, idx_max=-1):
    """A NUTS leaf routed by the mass matrix's rank: one ``ops.nuts_leaf``
    launch for a diagonal, :func:`nuts_leaf_dense` for a dense one."""
    leaf = nuts_leaf_dense if is_dense(m_inv, z) else ops.nuts_leaf
    return leaf(r_half, z, grad, pe, m_inv, eps, r_sum, r_ckpts,
                r_sum_ckpts, ckpt_i, idx_min, idx_max)


def _log(u: float) -> np.float32:
    return _F32(math.log(u)) if u > 0 else _F32(-np.inf)


def _leaf_scalars(energy, ref_energy, max_delta_energy):
    """A leaf's ``(weight, diverging, accept_prob)`` on the host: weight
    ``-(energy - ref_energy)`` in float32, a NaN delta counted as +inf."""
    delta = _F32(energy - ref_energy)
    if np.isnan(delta):
        delta = _F32(np.inf)
    diverging = bool(delta > max_delta_energy)
    accept_prob = _F32(1.0) if delta <= 0 else _F32(np.exp(-delta))
    return -delta, diverging, accept_prob


def _merge_scalars(u, current_weight, new_weight, new_stopped, biased):
    """``(total_weight, take_new)`` of merging a tree of ``new_weight``
    (``new_stopped``: it turned or diverged) into one of
    ``current_weight`` with the uniform ``u``: the biased-progressive
    transition of a doubling, or the multinomial one within a subtree."""
    total_weight = _F32(np.logaddexp(current_weight, new_weight))
    if biased:
        transition_lp = min(_F32(new_weight - current_weight), _F32(0))
        if new_stopped:
            transition_lp = _F32(-np.inf)
    else:
        transition_lp = _F32(new_weight - total_weight)
    return total_weight, bool(_log(u) < transition_lp)


def _leaf_tree(state: IntegratorState, energy, ref_energy, max_delta_energy):
    """A single-leaf tree with multinomial weight exp(-energy)."""
    weight, diverging, accept_prob = _leaf_scalars(energy, ref_energy,
                                                   max_delta_energy)
    return TreeState(
        z_left=state.z, r_left=state.r, z_left_grad=state.z_grad,
        z_right=state.z, r_right=state.r, z_right_grad=state.z_grad,
        z_proposal=state.z, z_proposal_pe=state.potential_energy,
        z_proposal_grad=state.z_grad, z_proposal_energy=_F32(energy),
        depth=0, weight=weight, r_sum=state.r, turning=False,
        diverging=diverging, sum_accept_probs=accept_prob, num_proposals=1)


def _combine_tree(u, current: TreeState, new: TreeState, going_right,
                  biased: bool, r_sum=None):
    """Merge ``new`` (grown in direction ``going_right``) into ``current``
    with the transition uniform ``u``.

    ``biased=True`` is the tree-level biased-progressive transition of a
    doubling; ``biased=False`` the within-subtree multinomial update.
    ``r_sum`` is the merged momentum sum when the caller already has it.
    The merged tree's own U-turn check is the caller's.
    """
    if going_right:
        left, right = current, new
    else:
        left, right = new, current
    total_weight, take_new = _merge_scalars(
        u, current.weight, new.weight, new.turning or new.diverging, biased)
    prop = new if take_new else current
    return TreeState(
        z_left=left.z_left, r_left=left.r_left, z_left_grad=left.z_left_grad,
        z_right=right.z_right, r_right=right.r_right,
        z_right_grad=right.z_right_grad,
        z_proposal=prop.z_proposal, z_proposal_pe=prop.z_proposal_pe,
        z_proposal_grad=prop.z_proposal_grad,
        z_proposal_energy=prop.z_proposal_energy,
        depth=current.depth + 1 if biased else current.depth,
        weight=total_weight,
        r_sum=current.r_sum + new.r_sum if r_sum is None else r_sum,
        turning=current.turning or new.turning,
        diverging=current.diverging or new.diverging,
        sum_accept_probs=_F32(current.sum_accept_probs
                              + new.sum_accept_probs),
        num_proposals=current.num_proposals + new.num_proposals)


def iterative_build_subtree(pe_and_grad, inverse_mass_matrix, step_size,
                            going_right, draws, initial: TreeState, depth,
                            max_depth, ref_energy, max_delta_energy, reads):
    """Paper Algorithm 2: grow a balanced subtree of up to 2**depth leaves
    by running the integrator iteratively, storing only O(max_depth)
    momentum checkpoints for the U-turn checks.  ``step_size`` is already
    signed for the direction.  Returns the subtree (not yet merged).

    The edge has no leaf to close, so the first leapfrog opens with one
    ``ops.leapfrog_halfstep``; after each potential evaluation one
    ``ops.nuts_leaf`` closes that leapfrog, forms the leaf's energy and
    U-turn dots (read back together) and opens the next leapfrog, which is
    dropped if the subtree stops there."""
    if going_right:
        z, r, grad = initial.z_right, initial.r_right, initial.z_right_grad
    else:
        z, r, grad = initial.z_left, initial.r_left, initial.z_left_grad
    z, r_half = halfstep(z, r, grad, inverse_mass_matrix, step_size)
    d = z.shape[0]
    # every row an odd leaf reads was written by an earlier even leaf
    r_ckpts = z.new_empty((max_depth, d))
    r_sum_ckpts = z.new_empty((max_depth, d))
    tree, r_sum = None, None
    for leaf_idx in range(2 ** depth):
        if tree is not None:
            if tree.turning or tree.diverging:
                break
            u = draws.leaf_uniform()
        pe, grad = pe_and_grad(z)
        ckpt_i, idx_min, idx_max = None, 0, -1
        if leaf_idx % 2 == 0:
            ckpt_i = _bit_count(leaf_idx)
        else:
            # the iterative U-turn check of every balanced subtree ending here
            idx_min, idx_max = _leaf_idx_to_ckpt_idxs(leaf_idx)
        r, r_sum, vals, z_next, r_half = nuts_leaf(
            r_half, z, grad, pe, inverse_mass_matrix, step_size, r_sum,
            r_ckpts, r_sum_ckpts, ckpt_i, idx_min, idx_max)
        vals = reads.read(vals)  # the leapfrog's one sync
        leaf = _leaf_tree(IntegratorState(z, r, pe, grad),
                          _F32(vals[0]) + _F32(vals[1]), ref_energy,
                          max_delta_energy)
        if tree is None:
            tree = leaf
        else:
            tree = _combine_tree(u, tree, leaf, going_right, biased=False,
                                 r_sum=r_sum)
            if not tree.diverging and any(v <= 0 for v in vals[2:]):
                tree = tree._replace(turning=True)
        z = z_next
    return tree


def build_tree(pe_and_grad, inverse_mass_matrix, step_size, draws,
               initial_state: IntegratorState, energy0, reads,
               max_tree_depth=10, max_delta_energy=1000.0):
    """One full NUTS trajectory: repeated doubling with iterative subtrees.
    ``pe_and_grad`` is the potential's value and gradient (``z -> (pe,
    grad)``); ``energy0`` the host value of the initial Hamiltonian;
    ``step_size`` a device scalar, negated once for the leftward
    direction."""
    tree = _leaf_tree(initial_state, energy0, energy0, max_delta_energy)
    # the root is not a proposal; don't let it bias the accept-prob statistic
    tree = tree._replace(sum_accept_probs=_F32(0), num_proposals=0)
    signed = {True: step_size, False: -step_size}
    while tree.depth < max_tree_depth and not tree.turning \
            and not tree.diverging:
        going_right = draws.direction()
        subtree = iterative_build_subtree(
            pe_and_grad, inverse_mass_matrix, signed[going_right], going_right,
            draws, tree, tree.depth, max_tree_depth, energy0,
            max_delta_energy, reads)
        u = draws.merge_uniform()
        merged = _combine_tree(u, tree, subtree, going_right, biased=True)
        turning = False
        if not (subtree.turning or subtree.diverging):
            turning = _is_turning(inverse_mass_matrix, merged.r_left,
                                  merged.r_right, merged.r_sum, reads)
        tree = merged._replace(turning=merged.turning or turning)
    return tree


# ---------------------------------------------------------------------------
# lockstep NUTS over C chains (the JAX package's vmap of build_tree)
# ---------------------------------------------------------------------------

def host_mask(mask, device):
    """A host (C,) bool array as a device bool tensor, copied without a
    sync: how the host's per-chain decisions reach the device."""
    return to_device(torch.from_numpy(np.ascontiguousarray(mask)), device)


def _rows(mask, like):
    """``mask`` (a (C,) device bool) shaped to broadcast over ``like``."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _where(mask, a, b):
    return torch.where(_rows(mask, a), a, b)


def rows_value_and_grad(potential_fn: Callable):
    """``(z (C, D), live (C,) host bool) -> (pe (C,), grad (C, D))`` for the
    live chains only, through :func:`chain_value_and_grad` (one GLM launch
    on the fused potential, else a loop over the rows, each row the same
    evaluation as a lone chain's); with some chains stopped the live rows
    are gathered and the results scattered back, the other rows zero."""
    batched = chain_value_and_grad(potential_fn)

    def evaluate(z, live):
        if live.all():
            return batched(z)
        idx = to_device(torch.from_numpy(np.flatnonzero(live)), z.device)
        pe_live, grad_live = batched(z.index_select(0, idx))
        pe = pe_live.new_zeros(z.shape[:1]).index_copy_(0, idx, pe_live)
        return pe, grad_live.new_zeros(z.shape).index_copy_(0, idx,
                                                            grad_live)

    return evaluate


def halfstep_chains(z, r, grad, inverse_mass_matrix, step_size, active):
    """Each active chain's half-kick and drift with its own signed step
    size: one ``ops.halfstep_chains`` launch for (C, D) diagonals, the dense
    plain form chain by chain for (C, D, D) matrices (reading ``active``,
    which waits for the card there), an inactive chain copied through."""
    if not is_dense(inverse_mass_matrix, z):
        return ops.halfstep_chains(z, r, grad, inverse_mass_matrix,
                                   step_size, active)
    return halfstep_chains_ref(z, r, grad, inverse_mass_matrix, step_size,
                               active, step=halfstep)


def nuts_leaf_chains(r_half, z, grad, pe, m_inv, eps, active, r_sum, r_ckpts,
                     r_sum_ckpts, ckpt_i=None, idx_min=0, idx_max=-1):
    """The lockstep leaf: one ``ops.nuts_leaf_batch`` launch for (C, D)
    diagonals; for dense (C, D, D) matrices :func:`nuts_leaf_dense` chain by
    chain, an inactive chain copied through as the kernel does."""
    args = (r_half, z, grad, pe, m_inv, eps, active, r_sum, r_ckpts,
            r_sum_ckpts, ckpt_i, idx_min, idx_max)
    if not is_dense(m_inv, z):
        return ops.nuts_leaf_batch(*args)
    return nuts_leaf_batch_ref(*args, leaf=nuts_leaf_dense)


def turning_dots_chains(inverse_mass_matrix, r_left, r_right, r_sum):
    """The (C, 2) U-turn dots of C merged trees: one
    ``ops.nuts_turning_batch`` launch for diagonals, the dense plain form
    chain by chain."""
    args = (inverse_mass_matrix, r_left, r_right, r_sum)
    if not is_dense(inverse_mass_matrix, r_right):
        return ops.nuts_turning_batch(*args)
    return nuts_turning_batch_ref(*args, dots=turning_dots_dense)


class TreeBatch:
    """The lockstep tree of C chains: the vectors lead with the chain axis
    on the device (edges, proposal, momentum sum), the scalars that steer
    each chain's tree are host (C,) arrays with the float32 semantics of
    :class:`TreeState`."""

    def __init__(self, z, r, grad, pe, energy, weight, diverging):
        c = z.shape[0]
        self.z_left = self.z_right = self.z_proposal = z
        self.r_left = self.r_right = self.r_sum = r
        self.z_left_grad = self.z_right_grad = self.z_proposal_grad = grad
        self.z_proposal_pe = pe
        self.z_proposal_energy = np.array(energy, np.float32)
        self.depth = np.zeros(c, np.int64)
        self.weight = np.array(weight, np.float32)
        self.turning = np.zeros(c, bool)
        self.diverging = np.array(diverging, bool)
        self.sum_accept_probs = np.zeros(c, np.float32)
        self.num_proposals = np.zeros(c, np.int64)


class _Subtree(NamedTuple):
    z_far: torch.Tensor          # the edge it grew to (its last leaf)
    r_far: torch.Tensor
    grad_far: torch.Tensor
    z_proposal: torch.Tensor
    z_proposal_pe: torch.Tensor
    z_proposal_grad: torch.Tensor
    r_sum: torch.Tensor
    energy: np.ndarray           # its proposal's energy
    weight: np.ndarray
    turning: np.ndarray
    diverging: np.ndarray
    sum_accept_probs: np.ndarray
    num_proposals: np.ndarray
    leaves: int                  # lockstep leaves it took


def iterative_build_subtree_batch(rows_pe_and_grad, inverse_mass_matrix,
                                  step_size, going_right, draws,
                                  tree: TreeBatch, active, depth, max_depth,
                                  ref_energy, max_delta_energy, reads):
    """:func:`iterative_build_subtree` for every chain of ``active`` at once
    (they share ``depth``, so every live chain is at the same leaf and reads
    the same checkpoint rows).  ``step_size`` is the device (C,) vector
    already signed for each chain's direction ``going_right``; ``draws``
    the chains' draw sources, each drawing exactly where a lone chain
    would.  A leaf is one potential evaluation of the live chains, one
    :func:`nuts_leaf_chains` and one host read of every chain's ``[pe, ke,
    dots...]``; a chain whose subtree turned or diverged stops (drawing
    nothing more) while the others go on."""
    dev = tree.z_left.device
    right = host_mask(going_right, dev)
    z0 = _where(right, tree.z_right, tree.z_left)
    r0 = _where(right, tree.r_right, tree.r_left)
    g0 = _where(right, tree.z_right_grad, tree.z_left_grad)
    live = active.copy()
    live_dev = host_mask(live, dev)
    z, r_half = halfstep_chains(z0, r0, g0, inverse_mass_matrix, step_size,
                                live_dev)
    c_num, d = z.shape
    r_ckpts = z.new_empty((c_num, max_depth, d))
    r_sum_ckpts = z.new_empty((c_num, max_depth, d))
    chains = np.flatnonzero(active)
    weight = np.zeros(c_num, np.float32)
    energy = np.zeros(c_num, np.float32)
    turning = np.zeros(c_num, bool)
    diverging = np.zeros(c_num, bool)
    sum_ap = np.zeros(c_num, np.float32)
    num = np.zeros(c_num, np.int64)
    uniforms = {}
    r_sum = far = prop = None
    leaves = 0
    for leaf_idx in range(2 ** depth):
        if leaf_idx > 0:
            stopped = live & (turning | diverging)
            if stopped.any():
                live &= ~stopped
                if not live.any():
                    break
                live_dev = host_mask(live, dev)
            chains = np.flatnonzero(live)
            uniforms = {c: draws[c].leaf_uniform() for c in chains}
        pe, grad = rows_pe_and_grad(z, live)
        ckpt_i, idx_min, idx_max = None, 0, -1
        if leaf_idx % 2 == 0:
            ckpt_i = _bit_count(leaf_idx)
        else:
            idx_min, idx_max = _leaf_idx_to_ckpt_idxs(leaf_idx)
        r, r_sum, vals, z_next, r_half = nuts_leaf_chains(
            r_half, z, grad, pe, inverse_mass_matrix, step_size, live_dev,
            r_sum, r_ckpts, r_sum_ckpts, ckpt_i, idx_min, idx_max)
        vals = reads.read(vals)  # the lockstep leapfrog's one sync
        leaves += 1
        take = np.zeros(c_num, bool)
        for c in chains:
            row = vals[c]
            leaf_energy = _F32(row[0]) + _F32(row[1])
            w, div, ap = _leaf_scalars(leaf_energy, ref_energy[c],
                                       max_delta_energy)
            if leaf_idx == 0:
                weight[c], diverging[c], sum_ap[c], num[c] = w, div, ap, 1
                take[c] = True
            else:
                weight[c], take[c] = _merge_scalars(
                    uniforms[c], weight[c], w, div, biased=False)
                diverging[c] = diverging[c] or div
                sum_ap[c] = _F32(sum_ap[c] + ap)
                num[c] += 1
                if not diverging[c] and any(v <= 0 for v in row[2:]):
                    turning[c] = True
            if take[c]:
                energy[c] = leaf_energy
        if leaf_idx == 0:
            far = (z, r, grad)
            prop = (z, pe, grad)
        else:
            far = tuple(_where(live_dev, new, old)
                        for new, old in zip((z, r, grad), far))
            take_dev = host_mask(take, dev)
            prop = tuple(_where(take_dev, new, old)
                         for new, old in zip((z, pe, grad), prop))
        z = z_next
    return _Subtree(*far, *prop, r_sum, energy, weight, turning, diverging,
                    sum_ap, num, leaves)


def build_tree_batch(rows_pe_and_grad, inverse_mass_matrix, step_size, draws,
                     initial_state: IntegratorState, energy0, reads,
                     max_tree_depth=10, max_delta_energy=1000.0):
    """One NUTS trajectory for each of C chains, in lockstep: the doublings
    of :func:`build_tree` run while any chain's tree is still growing, a
    chain that turned, diverged or reached ``max_tree_depth`` is masked
    out.  ``rows_pe_and_grad`` is :func:`rows_value_and_grad` of the
    potential; ``initial_state`` holds (C, ...) tensors, ``energy0`` the
    host (C,) float32 Hamiltonians, ``step_size`` the device (C,) step
    sizes; ``draws[c]`` is chain c's draw source.  Each chain draws the
    same values at the same points as :func:`build_tree` alone, and its
    host arithmetic is the same; on the CPU (the plain versions) chain c's
    tree is bit-identical to :func:`build_tree`'s.  Returns the
    :class:`TreeBatch` and the lockstep leaves it took."""
    c_num = initial_state.z.shape[0]
    weight, diverging = zip(*((w, div) for w, div, _ in (
        _leaf_scalars(e, e, max_delta_energy) for e in energy0)))
    tree = TreeBatch(initial_state.z, initial_state.r, initial_state.z_grad,
                     initial_state.potential_energy, energy0, weight,
                     diverging)
    dev = initial_state.z.device
    leaves = 0
    while True:
        active = (tree.depth < max_tree_depth) & ~tree.turning \
            & ~tree.diverging
        if not active.any():
            break
        going_right = np.zeros(c_num, bool)
        for c in np.flatnonzero(active):
            going_right[c] = draws[c].direction()
        right = host_mask(going_right, dev)
        signed = torch.where(right, step_size, -step_size)
        sub = iterative_build_subtree_batch(
            rows_pe_and_grad, inverse_mass_matrix, signed, going_right,
            draws, tree, active, int(tree.depth[active][0]), max_tree_depth,
            energy0, max_delta_energy, reads)
        leaves += sub.leaves
        take = np.zeros(c_num, bool)
        for c in np.flatnonzero(active):
            u = draws[c].merge_uniform()
            stopped = bool(sub.turning[c] or sub.diverging[c])
            tree.weight[c], take[c] = _merge_scalars(
                u, tree.weight[c], sub.weight[c], stopped, biased=True)
            if take[c]:
                tree.z_proposal_energy[c] = sub.energy[c]
            tree.depth[c] += 1
            tree.turning[c] = tree.turning[c] or sub.turning[c]
            tree.diverging[c] = tree.diverging[c] or sub.diverging[c]
            tree.sum_accept_probs[c] = _F32(tree.sum_accept_probs[c]
                                            + sub.sum_accept_probs[c])
            tree.num_proposals[c] += sub.num_proposals[c]
        act = host_mask(active, dev)
        to_right = host_mask(active & going_right, dev)
        to_left = host_mask(active & ~going_right, dev)
        tree.z_right = _where(to_right, sub.z_far, tree.z_right)
        tree.r_right = _where(to_right, sub.r_far, tree.r_right)
        tree.z_right_grad = _where(to_right, sub.grad_far, tree.z_right_grad)
        tree.z_left = _where(to_left, sub.z_far, tree.z_left)
        tree.r_left = _where(to_left, sub.r_far, tree.r_left)
        tree.z_left_grad = _where(to_left, sub.grad_far, tree.z_left_grad)
        took = host_mask(take, dev)
        tree.z_proposal = _where(took, sub.z_proposal, tree.z_proposal)
        tree.z_proposal_pe = _where(took, sub.z_proposal_pe,
                                    tree.z_proposal_pe)
        tree.z_proposal_grad = _where(took, sub.z_proposal_grad,
                                      tree.z_proposal_grad)
        tree.r_sum = _where(act, tree.r_sum + sub.r_sum, tree.r_sum)
        check = active & ~(sub.turning | sub.diverging)
        if check.any():
            dots = reads.read(turning_dots_chains(
                inverse_mass_matrix, tree.r_left, tree.r_right, tree.r_sum))
            for c in np.flatnonzero(check):
                if dots[c][0] <= 0 or dots[c][1] <= 0:
                    tree.turning[c] = True
    return tree, leaves


# ---------------------------------------------------------------------------
# cross-chain (ensemble) helpers
# ---------------------------------------------------------------------------

def chain_mean(x):
    return chain_sum(x) / x.shape[0]


def welford_ratios(n_a, n_b):
    """The count ratios ``n_b / n`` and ``n_a n_b / n`` of merging two
    accumulators of ``n_a`` and ``n_b`` draws, in float32 as in the JAX
    package, as host numbers."""
    n_a, n_b = _F32(n_a), _F32(n_b)
    n_safe = max(n_a + n_b, _F32(1))
    return float(n_b / n_safe), float(n_a * n_b / n_safe)


def welford_combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Exact merge of two Welford accumulators (Chan et al. 1979); either
    may be empty."""
    mean, m2 = welford_merge(a.mean, a.m2, b.mean, b.m2,
                             *welford_ratios(a.n, b.n))
    return WelfordState(mean, m2, a.n + b.n)


def welford_batch(x) -> WelfordState:
    """The accumulator of every row of ``x`` (``(batch, dim)``) in one
    vectorized pass, reduced with :func:`chain_sum`."""
    return WelfordState(*welford_moments(x), x.shape[0])


def welford_pool(states: WelfordState) -> WelfordState:
    """Pool a chain-batch of accumulators (``mean``/``m2`` lead with the
    chain axis, ``n`` one count per chain) into the accumulator of all
    their draws at once."""
    counts = [int(n) for n in (states.n.tolist()
                               if isinstance(states.n, torch.Tensor)
                               else states.n)]
    n_c = torch.tensor(counts, dtype=states.mean.dtype,
                       device=states.mean.device)
    n_safe = torch.clamp(chain_sum(n_c), min=1.0)
    nb = n_c.reshape((-1,) + (1,) * (states.mean.dim() - 1))
    mean = chain_sum(nb * states.mean) / n_safe
    delta = states.mean - mean
    if states.m2.dim() == states.mean.dim():      # diagonal
        m2 = chain_sum(states.m2) + chain_sum(nb * delta * delta)
    else:                                         # dense
        m2 = chain_sum(states.m2) + chain_sum(
            n_c[:, None, None] * delta[:, :, None] * delta[:, None, :])
    return WelfordState(mean, m2, sum(counts))


def chain_value_and_grad(potential_fn: Callable):
    """``(C, D) -> ((C,) potentials, (C, D) gradients)``: the counterpart of
    the JAX package's ``chain_vmap(jax.value_and_grad(potential))``.

    A potential with a batched entry, ``value_and_grad_batch`` (the fused
    GLM potential, ``glm.py``: its prior under ``torch.func.vmap``, one GLM
    kernel launch and one pass over X for all C chains), is called once.
    Any other potential is a loop over the chains, one value-and-gradient
    evaluation each, stacked: a model's potential may branch on its data
    or call into ctypes, which ``torch.func.vmap`` cannot enter."""
    batch = getattr(potential_fn, "value_and_grad_batch", None)
    if batch is not None:
        return batch
    pe_and_grad = value_and_grad(potential_fn)

    def batched(z):
        pes, grads = zip(*(pe_and_grad(row) for row in z))
        return torch.stack(pes), torch.stack(grads)

    return batched


def velocity_verlet_batch(potential_fn: Callable):
    """Chain-batched leapfrog trajectory over a (C, D) ensemble with merged
    interior kicks (diagonal mass): the opening half-kick and drift, then
    ``num_steps - 1`` full kicks and drifts, through
    ``ops.leapfrog_halfstep_batch`` (one launch each), then the closing
    half-kick.  The same positions and the same ``num_steps`` ensemble
    gradients as ``num_steps`` plain leapfrogs.

    Returns ``trajectory(step_size, inverse_mass_matrix, state, num_steps)``
    for a host ``step_size`` and ``num_steps >= 1``."""
    pe_and_grad = chain_value_and_grad(potential_fn)

    def trajectory(step_size, inverse_mass_matrix, state: IntegratorState,
                   num_steps):
        def kick_drift(s, kick):
            z, r = ops.leapfrog_halfstep_batch(s.z, s.r, s.z_grad,
                                               inverse_mass_matrix,
                                               step_size, kick)
            pe, z_grad = pe_and_grad(z)
            return IntegratorState(z, r, pe, z_grad)

        s = kick_drift(state, 0.5)                  # opening half-kick
        for _ in range(num_steps - 1):
            s = kick_drift(s, 1.0)
        r = s.r - 0.5 * step_size * s.z_grad        # closing half-kick
        return IntegratorState(s.z, r, s.potential_energy, s.z_grad)

    return trajectory
