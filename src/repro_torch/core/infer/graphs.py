"""ChEES's lockstep trajectory, replayed from CUDA graphs on a card.

The JAX package compiles a ChEES transition whole: its trajectory is a
``lax.fori_loop`` of the batch leapfrog kernel and the vmapped potential,
so nothing is issued per leapfrog.  Eager PyTorch issues each leapfrog's
~33 kernels from the host, which took ~2.4 ms an ensemble leapfrog against
~0.17 ms of device work.  The card's counterpart of the compiled loop is a
CUDA graph: the chains move in lockstep for a ``num_steps`` fixed on the
host before the trajectory starts, so a leapfrog holds no host decision
and replays as one graph:

- the opening graph: ``ops.chees_open`` (the momenta from the
  standard-normal draw and the opening half-kick and drift, row 3's kernel)
  then the potential's value and gradient for all chains;
- the interior graph: ``ops.leapfrog_halfstep_batch`` with the merged kick
  (1.0) then the potential.

A transition replays the opening graph once and the interior graph
``num_steps - 1`` times.  Their inputs are fixed buffers of
:class:`_Buffers`, one set per ``(C, D, dtype, device)``: the positions and
gradient (copied in from the state), the momenta, ``m_inv`` (copied in when
the state's tensor changes, at a window end), and one staging buffer that
holds the draw, the accept uniforms and the step size, filled by one
host->device copy a transition from one pinned buffer (the caching host
allocator keeps the pinned block until its copy has run).  The kernels read
``eps`` from there, so a replay uses the step size of its transition.  The
trajectory's end is read from the buffers by ``ops.chees_accept`` before
the next transition writes them.

Only a potential whose batched entry runs its prior under
``torch.func.vmap`` (the fused GLM potential with ``glm_prior_batch ==
"vmap"``, ``core/infer/glm.py``) is graphed: ``vmap`` refuses Python
control flow on values, so the captured prior is the same function at
every replay.  Any other potential, and the CPU, runs the same functions
eagerly.  The choice is made at setup and recorded (``MCMC.stats``:
``trajectory_graph``); a capture that fails raises.  A trajectory whose
ensemble rows are split over a mesh's chain ranks
(``chain_method="parallel"``: the potential gathers over the process
group) runs eagerly, and ``trajectory_graph`` then says False.

Each body's first call runs eagerly on the capture stream (its launches
run and count as any other; it is also the warmup a capture needs:
libraries loaded, per-stream buffers such as the GLM kernel's tickets
made), and is then captured, with Python's garbage collector paused (a
dead run's graphs freed during a capture would end it).  What the
captured region does on the host runs only at capture: the wrappers'
checks, the launch counters (``ops.counters()``) and the potential's
``count`` (``hmc.counting``).
Each counter's increase during capture is taken back and added again at
every replay, so every counter equals the launches the card ran.
"""
from __future__ import annotations

import gc
import time

import torch

from ...distributed import sharding
from ...kernels import ops
from .hmc_util import chain_value_and_grad


class _Buffers:
    """The graphs' fixed inputs and outputs for one ``(C, D, dtype,
    device)``, and the two graphed bodies."""

    def __init__(self, c, d, dtype, device):
        def empty(*shape):
            return torch.empty(shape, dtype=dtype, device=device)

        self.z, self.r, self.g = empty(c, d), empty(c, d), empty(c, d)
        self.m = empty(d)
        self.m_src = None  # the state's m_inv tensor last copied in
        # one copy a transition: [draw (C * D), uniforms (C), eps (1)]
        self.stage = empty(c * d + c + 1)
        self.n = self.stage[:c * d].view(c, d)
        self.u = self.stage[c * d:c * d + c]
        self.eps = self.stage[c * d + c:]
        self.opening = self.interior = None


class _GraphedBody:
    """A trajectory body: run eagerly on its first call, then captured and
    replayed.  ``__call__`` returns the potentials (C,) it produced."""

    def __init__(self, name, body, owner):
        self.name, self.body, self.owner = name, body, owner
        self.graph, self.pe, self.deltas = None, None, []

    def __call__(self):
        owner = self.owner
        if self.graph is not None:
            self.graph.replay()
            for (obj, attr), delta in self.deltas:
                setattr(obj, attr, getattr(obj, attr) + delta)
            owner.replays[self.name] += 1
            return self.pe
        main = torch.cuda.current_stream()
        side = owner.capture_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            pe = self.body()
        main.wait_stream(side)
        pe.record_stream(main)
        owner.eager_bodies[self.name] += 1
        t0 = time.perf_counter()
        counters = owner.counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a dead reference cycle that
        # holds another trajectory's graphs (a finished or killed run's),
        # freed mid-capture, would end the capture with an error
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                self.pe = self.body()
        finally:
            if collecting:
                gc.enable()
        after = [getattr(obj, attr) for obj, attr in counters]
        for (obj, attr), value in zip(counters, before):
            setattr(obj, attr, value)  # the capture ran nothing
        self.deltas = [(pair, a - b) for pair, b, a in
                       zip(counters, before, after) if a != b]
        self.graph = graph
        owner.capture_seconds += time.perf_counter() - t0
        return pe


class EnsembleTrajectory:
    """``trajectory(z, z_grad, n, m_inv, eps, num_steps) -> (z, r, pe,
    z_grad)``: ``num_steps >= 1`` lockstep leapfrogs of a (C, D) ensemble
    from momenta ``n / sqrt(m_inv)`` (``n`` the standard-normal draw), the
    last one's closing half-kick left to ``ops.chees_accept``.

    ``graphed`` (a card, a potential that can be replayed) replays the two
    graphs of the module docstring and returns views of fixed buffers,
    valid until the next call; otherwise the same functions run eagerly.
    :meth:`stage` moves a transition's draws (and, on a card, the step size)
    to the device."""

    def __init__(self, potential_fn, graphed: bool):
        self.potential_fn = potential_fn
        self.pe_and_grad = chain_value_and_grad(potential_fn)
        self.graphed = bool(graphed)
        self._buffers = {}
        self._stream = None
        self.replays = {"opening": 0, "interior": 0}
        self.eager_bodies = {"opening": 0, "interior": 0}
        self.capture_seconds = 0.0
        self.split_runs = 0  # trajectories run eagerly under a chain split

    def counters(self):
        """The counters a captured body bumps on the host."""
        pairs = ops.counters()
        if hasattr(self.potential_fn, "count"):
            pairs.append((self.potential_fn, "count"))
        return pairs

    def capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def stats(self) -> dict:
        return {"trajectory_graph": self.graphed and not self.split_runs,
                "graph_replays": dict(self.replays),
                "graph_eager_bodies": dict(self.eager_bodies),
                "graph_capture_seconds": self.capture_seconds}

    def _buffers_for(self, c, d, dtype, device):
        if device.index is None:  # "cuda": the current card
            device = torch.device("cuda", torch.cuda.current_device())
        key = (c, d, dtype, device)
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = _Buffers(c, d, dtype, device)
        return bufs

    def stage(self, n, u, step_size, device):
        """The draw ``n`` (C, D), the uniforms ``u`` (C,) and the step size
        on ``device`` -> ``(n, u, eps)``: on a card one host->device copy
        of all three (``eps`` a one-element tensor), else ``eps`` the host
        number."""
        device = torch.device(device)
        if device.type != "cuda":
            return n.to(device), u.to(device), float(step_size)
        c, d = n.shape
        bufs = self._buffers_for(c, d, n.dtype, device)
        host = torch.empty(bufs.stage.shape, dtype=n.dtype, pin_memory=True)
        host[:c * d].copy_(n.reshape(-1))
        host[c * d:c * d + c].copy_(u)
        host[c * d + c] = float(step_size)
        bufs.stage.copy_(host, non_blocking=True)
        return bufs.n, bufs.u, bufs.eps

    def __call__(self, z, z_grad, n, m_inv, eps, num_steps):
        split = sharding.active_ensemble_split() is not None
        self.split_runs += int(split)
        if not self.graphed or split:
            z, r = ops.chees_open(z, n, z_grad, m_inv, eps)
            pe, g = self.pe_and_grad(z)
            for _ in range(num_steps - 1):
                z, r = ops.leapfrog_halfstep_batch(z, r, g, m_inv, eps, 1.0)
                pe, g = self.pe_and_grad(z)
            return z, r, pe, g
        bufs = self._buffers_for(*z.shape, z.dtype, z.device)
        if n.data_ptr() != bufs.n.data_ptr() \
                or eps.data_ptr() != bufs.eps.data_ptr():
            raise ValueError("a graphed trajectory takes the draw and the "
                             "step size from its own stage()")
        if bufs.opening is None:
            bufs.opening = _GraphedBody("opening", lambda: self._open(bufs),
                                        self)
            bufs.interior = _GraphedBody(
                "interior", lambda: self._kick_drift(bufs), self)
        bufs.z.copy_(z)
        bufs.g.copy_(z_grad)
        if m_inv is not bufs.m_src:
            bufs.m.copy_(m_inv)
            bufs.m_src = m_inv
        pe = bufs.opening()
        for _ in range(num_steps - 1):
            pe = bufs.interior()
        return bufs.z, bufs.r, pe, bufs.g

    def _open(self, bufs):
        ops.chees_open(bufs.z, bufs.n, bufs.g, bufs.m, bufs.eps,
                       out=(bufs.z, bufs.r))
        return self._potential(bufs)

    def _kick_drift(self, bufs):
        ops.leapfrog_halfstep_batch(bufs.z, bufs.r, bufs.g, bufs.m, bufs.eps,
                                    1.0, out=(bufs.z, bufs.r))
        return self._potential(bufs)

    def _potential(self, bufs):
        pe, g = self.pe_and_grad(bufs.z)
        bufs.g.copy_(g)
        return pe
