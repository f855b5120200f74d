"""HMC/NUTS numerical core.

The centerpiece is :func:`iterative_build_subtree` — the paper's Algorithm 2:
the *iterative* form of the recursive BuildTree, which keeps O(log N)
memory through bit-count-indexed momentum checkpoints.

In the JAX package the whole trajectory is one ``lax.while_loop``.  Here the
loops are Python loops: vectors (position, momentum, gradient, checkpoints)
stay on the device, and the scalars that steer the tree (energies, U-turn
dot products) come back to the host once per leapfrog, in one read
(:class:`HostReads` counts them), with a second read per doubling for the
merged tree's U-turn check.  The tree's scalar state is kept on the host in
float32, so the ``lax.cond``/``jnp.where`` selections of the JAX package
become Python ``if``s over references, with the same semantics.

Randomness comes from a *draw source* (:class:`GeneratorDraws` by default)
so that a test can replay another implementation's draws: momentum normals,
direction bits, and the transition uniforms (and, for the ensemble samplers,
their ``(C, D)`` momenta and noise and ``(C,)`` uniforms).

The cross-chain helpers at the end serve the ensemble samplers (ChEES,
MALA/RWM): the pairwise ``chain_sum`` fold, the pooled Welford
accumulators, the chain-batched potential gradient and the ``(C, D)``
trajectory with merged interior kicks.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ...kernels import ops

_F32 = np.float32


class HostReads:
    """Every device->host read the sampler makes, counted.  On a card each
    read waits for the device: the count is the number of host syncs."""

    def __init__(self):
        self.count = 0

    def read(self, tensor) -> list:
        self.count += 1
        return tensor.tolist()


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


def kinetic_energy(inverse_mass_matrix, r):
    """``0.5 r . (m_inv * r)``; a ``(C, D)`` ensemble gives ``(C,)``."""
    if r.dim() == 1:
        return 0.5 * torch.dot(r, inverse_mass_matrix * r)
    return 0.5 * torch.sum(r * (inverse_mass_matrix * r), -1)


def momentum_sample(eps, inverse_mass_matrix):
    """r ~ N(0, M) with M = imm^{-1}, from a standard normal ``eps``."""
    return eps / torch.sqrt(inverse_mass_matrix)


def value_and_grad(potential_fn: Callable):
    """``z -> (potential, dpotential/dz)`` through ``torch.autograd``."""
    def pe_and_grad(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            pe = potential_fn(z)
            (grad,) = torch.autograd.grad(pe, z)
        return pe.detach(), grad

    return pe_and_grad


def velocity_verlet(potential_fn: Callable):
    """Single leapfrog step closure (diagonal mass).  The memory-bound half
    of the step — momentum half-kick and position drift — goes through the
    fused ``ops.leapfrog_halfstep``; ``step_size`` may be a device scalar,
    which the kernel reads from device memory."""
    pe_and_grad = value_and_grad(potential_fn)

    def init(z):
        return pe_and_grad(z)

    def update(step_size, inverse_mass_matrix, state: IntegratorState):
        z, r = ops.leapfrog_halfstep(state.z, state.r, state.z_grad,
                                     inverse_mass_matrix, step_size)
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
# Welford online variance (diagonal)
# ---------------------------------------------------------------------------

class WelfordState(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    n: int


def welford_init(size, dtype=torch.float32, device="cpu"):
    zeros = torch.zeros(size, dtype=dtype, device=device)
    return WelfordState(zeros, zeros.clone(), 0)


def welford_update(state: WelfordState, x):
    mean, m2, n = state
    n = n + 1
    delta_pre = x - mean
    mean = mean + delta_pre / n
    delta_post = x - mean
    return WelfordState(mean, m2 + delta_pre * delta_post, n)


def welford_covariance(state: WelfordState, regularize=True):
    mean, m2, n = state
    nf = float(max(n, 2))
    cov = m2 / (nf - 1)
    if regularize:  # Stan's shrinkage toward identity
        cov = (nf / (nf + 5.0)) * cov + 1e-3 * (5.0 / (nf + 5.0))
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


def _turning_dots(inverse_mass_matrix, r_left, r_right, r_sum):
    """The two dot products of the generalized U-turn criterion
    (Betancourt) on momentum sums; ``r_left`` may carry a leading batch of
    checkpoints.  The tree turns where either is <= 0."""
    r_mid = r_sum - 0.5 * (r_left + r_right)
    return torch.stack([torch.sum(inverse_mass_matrix * r_left * r_mid, -1),
                        torch.sum(inverse_mass_matrix * r_right * r_mid, -1)])


def _is_turning(inverse_mass_matrix, r_left, r_right, r_sum, reads) -> bool:
    dots = reads.read(_turning_dots(inverse_mass_matrix, r_left, r_right,
                                    r_sum))
    return dots[0] <= 0 or dots[1] <= 0


def _log(u: float) -> np.float32:
    return _F32(math.log(u)) if u > 0 else _F32(-np.inf)


def _leaf_tree(state: IntegratorState, energy, ref_energy, max_delta_energy):
    """A single-leaf tree with multinomial weight exp(-energy)."""
    delta = _F32(energy - ref_energy)
    if np.isnan(delta):
        delta = _F32(np.inf)
    diverging = bool(delta > max_delta_energy)
    accept_prob = _F32(1.0) if delta <= 0 else _F32(np.exp(-delta))
    return TreeState(
        z_left=state.z, r_left=state.r, z_left_grad=state.z_grad,
        z_right=state.z, r_right=state.r, z_right_grad=state.z_grad,
        z_proposal=state.z, z_proposal_pe=state.potential_energy,
        z_proposal_grad=state.z_grad, z_proposal_energy=_F32(energy),
        depth=0, weight=-delta, r_sum=state.r, turning=False,
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
    total_weight = _F32(np.logaddexp(current.weight, new.weight))
    if biased:
        transition_lp = min(_F32(new.weight - current.weight), _F32(0))
        if new.turning or new.diverging:
            transition_lp = _F32(-np.inf)
    else:
        transition_lp = _F32(new.weight - total_weight)
    prop = new if _log(u) < transition_lp else current
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


def _read_leaf(nxt: IntegratorState, inverse_mass_matrix, ref_energy,
               max_delta_energy, reads, dots=None):
    """The leaf tree of a new integrator state.  Its energy and the U-turn
    ``dots`` (if any) come back in one host read — the one sync of a
    leapfrog; returns the leaf and the host values of ``dots``."""
    ke = kinetic_energy(inverse_mass_matrix, nxt.r)
    parts = [nxt.potential_energy.reshape(1), ke.reshape(1)]
    if dots is not None:
        parts.append(dots.reshape(-1))
    vals = reads.read(torch.cat(parts))
    leaf = _leaf_tree(nxt, _F32(vals[0]) + _F32(vals[1]), ref_energy,
                      max_delta_energy)
    return leaf, vals[2:]


def iterative_build_subtree(vv_update, inverse_mass_matrix, step_size,
                            going_right, draws, initial: TreeState, depth,
                            max_depth, ref_energy, max_delta_energy, reads):
    """Paper Algorithm 2: grow a balanced subtree of up to 2**depth leaves
    by running the integrator iteratively, storing only O(max_depth)
    momentum checkpoints for the U-turn checks.  ``step_size`` is already
    signed for the direction.  Returns the subtree (not yet merged)."""
    if going_right:
        edge = IntegratorState(initial.z_right, initial.r_right,
                               initial.z_proposal_pe, initial.z_right_grad)
    else:
        edge = IntegratorState(initial.z_left, initial.r_left,
                               initial.z_proposal_pe, initial.z_left_grad)
    nxt = vv_update(step_size, inverse_mass_matrix, edge)
    tree, _ = _read_leaf(nxt, inverse_mass_matrix, ref_energy,
                         max_delta_energy, reads)
    d = nxt.r.shape[0]
    r_ckpts = nxt.r.new_zeros((max_depth, d))
    r_sum_ckpts = nxt.r.new_zeros((max_depth, d))
    r_ckpts[0] = nxt.r
    r_sum_ckpts[0] = nxt.r
    num_leaves = 2 ** depth
    leaf_idx = 1
    while leaf_idx < num_leaves and not tree.turning and not tree.diverging:
        u = draws.leaf_uniform()
        nxt = vv_update(step_size, inverse_mass_matrix, nxt)
        # r_sum over the leaves of this subtree, through the new leaf
        r_sum_through = tree.r_sum + nxt.r
        is_even = leaf_idx % 2 == 0
        dots = None
        if is_even:
            ckpt_i = _bit_count(leaf_idx)
            r_ckpts[ckpt_i] = nxt.r
            r_sum_ckpts[ckpt_i] = r_sum_through
        else:
            idx_min, idx_max = _leaf_idx_to_ckpt_idxs(leaf_idx)
            if idx_min <= idx_max:
                rc = r_ckpts[idx_min:idx_max + 1]
                subtree_r_sum = (r_sum_through
                                 - r_sum_ckpts[idx_min:idx_max + 1] + rc)
                dots = _turning_dots(inverse_mass_matrix, rc, nxt.r,
                                     subtree_r_sum)
        leaf, dot_vals = _read_leaf(nxt, inverse_mass_matrix, ref_energy,
                                    max_delta_energy, reads, dots)
        tree = _combine_tree(u, tree, leaf, going_right, biased=False,
                             r_sum=r_sum_through)
        # the iterative U-turn check of every balanced subtree ending here
        if not tree.diverging and any(v <= 0 for v in dot_vals):
            tree = tree._replace(turning=True)
        leaf_idx += 1
    return tree


def build_tree(vv_update, inverse_mass_matrix, step_size, draws,
               initial_state: IntegratorState, energy0, reads,
               max_tree_depth=10, max_delta_energy=1000.0):
    """One full NUTS trajectory: repeated doubling with iterative subtrees.
    ``energy0`` is the host value of the initial Hamiltonian; ``step_size``
    a device scalar, negated once for the leftward direction."""
    tree = _leaf_tree(initial_state, energy0, energy0, max_delta_energy)
    # the root is not a proposal; don't let it bias the accept-prob statistic
    tree = tree._replace(sum_accept_probs=_F32(0), num_proposals=0)
    signed = {True: step_size, False: -step_size}
    while tree.depth < max_tree_depth and not tree.turning \
            and not tree.diverging:
        going_right = draws.direction()
        subtree = iterative_build_subtree(
            vv_update, inverse_mass_matrix, signed[going_right], going_right,
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
# cross-chain (ensemble) helpers
# ---------------------------------------------------------------------------

def chain_sum(x):
    """Sum over the leading (chain) axis by the JAX package's fixed pairwise
    fold (halves added, an odd row carried), not ``torch.sum``: the pooled
    statistics then have the reference's association exactly."""
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        folded = x[:half] + x[half:2 * half]
        if n % 2:
            folded = torch.cat([folded, x[2 * half:]], 0)
        x = folded
    return x[0]


def chain_mean(x):
    return chain_sum(x) / x.shape[0]


def welford_combine(a: WelfordState, b: WelfordState) -> WelfordState:
    """Exact merge of two Welford accumulators (Chan et al. 1979); either
    may be empty.  The count ratios are float32, as in the JAX package."""
    n_a, n_b = _F32(a.n), _F32(b.n)
    n_safe = max(n_a + n_b, _F32(1))
    delta = b.mean - a.mean
    mean = a.mean + delta * float(n_b / n_safe)
    m2 = a.m2 + b.m2 + (delta * delta) * float(n_a * n_b / n_safe)
    return WelfordState(mean, m2, a.n + b.n)


def welford_batch(x) -> WelfordState:
    """The accumulator of every row of ``x`` (``(batch, dim)``) in one
    vectorized pass, reduced with :func:`chain_sum`."""
    mean = chain_mean(x)
    centered = x - mean
    return WelfordState(mean, chain_sum(centered * centered), x.shape[0])


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
    m2 = chain_sum(states.m2) + chain_sum(nb * delta * delta)
    return WelfordState(mean, m2, sum(counts))


def chain_value_and_grad(potential_fn: Callable):
    """``(C, D) -> ((C,) potentials, (C, D) gradients)``: the counterpart of
    the JAX package's ``chain_vmap(jax.value_and_grad(potential))``.

    A loop over the chains, one value-and-gradient evaluation each, stacked:
    the fused GLM potential is a ctypes-backed ``torch.autograd.Function``
    that ``torch.func.vmap`` cannot enter, so on the logistic regression
    each evaluation of the ensemble launches the GLM kernel once per chain,
    one pass over X per chain (as ``jax.vmap`` of the Pallas kernel does)."""
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
