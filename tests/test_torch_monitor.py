"""Convergence-gated runs on the port (``repro_torch.obs.monitor``) against
the JAX package's ``repro.obs.monitor``.

- Level 1, the same numpy draws into both packages: ``StreamingDiagnostics``
  (fold, ``split_rhat``, ``ess``, ``state_dict``; one stream chunked
  several ways), ``ConvergenceMonitor`` decisions with each package loading
  the other's ``state_dict``, ``Converged.satisfied`` with NaN, and RPL403's
  findings, message for message.  Equal bits everywhere.
- The executor's contract on the CPU (the reference's tests/test_monitor.py
  at the port's scale): a gated run draws the ungated run's prefix bit for
  bit on every path; RPL403 and a non-``Converged`` ``until`` raise before
  the first transition; ``sequential`` rejects gating; a gated kill/resume
  stops at the uninterrupted run's iteration, and an ungated checkpoint
  resumed with ``until=`` re-folds its draws to the same decision.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import repro.obs.monitor as jmon
from repro.lint_rules.obs_rules import verify_until as j_verify_until
import repro_torch.core as pc
from repro_torch.core import dist
from repro_torch.core.errors import ReproValueError
from repro_torch.core.infer import HMC, MCMC, NUTS, RWM, ChEES, MALA
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.lint_rules.obs_rules import verify_until
from repro_torch.obs import monitor as mon
from repro_torch.obs import Converged, Telemetry
from repro_torch.obs.manifest import RunManifest

WARMUP, SAMPLES, EVERY, SEED = 24, 36, 20, 11


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tensors are tiny: torch's thread pool only adds overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ar1(rng, rho, c, n, d):
    x = np.empty((c, n, d))
    innov = rng.normal(size=(c, n, d)) * np.sqrt(1.0 - rho ** 2)
    x[:, 0] = rng.normal(size=(c, d))
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + innov[:, t]
    return x


def _assert_same_state(port_sd, ref_sd):
    """Two ``state_dict``s equal key for key, through JSON."""
    assert json.dumps(port_sd, sort_keys=True) == json.dumps(ref_sd,
                                                             sort_keys=True)


# ---------------------------------------------------------------------------
# level 1: the same draws, the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cuts", [[157], [1] * 157, [7, 13, 1, 29, 107],
                                  [80, 77], [9, 9, 9, 130]])
def test_streaming_diagnostics_bits_match_reference(cuts):
    rng = np.random.default_rng(3)
    x = _ar1(rng, 0.6, 4, 157, 2)
    x[1] += 0.4
    ours, ref = mon.StreamingDiagnostics(10), jmon.StreamingDiagnostics(10)
    start = 0
    for k in cuts:
        ours.fold(x[:, start:start + k])
        ref.fold(x[:, start:start + k])
        start += k
        np.testing.assert_array_equal(ours.split_rhat(), ref.split_rhat())
        np.testing.assert_array_equal(ours.ess(), ref.ess())
    assert ours.num_draws == ref.num_draws == 157
    _assert_same_state(ours.state_dict(), ref.state_dict())


def test_state_dicts_load_across_packages():
    """Each package loads the other's ``state_dict`` mid-batch (through
    JSON) and keeps folding to the same bits."""
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(4, 47, 3)), rng.normal(size=(4, 53, 3))
    ours, ref = mon.StreamingDiagnostics(10), jmon.StreamingDiagnostics(10)
    ours.fold(a)
    ref.fold(a)
    ours_from_ref = mon.StreamingDiagnostics.from_state_dict(
        json.loads(json.dumps(ref.state_dict())))
    ref_from_ours = jmon.StreamingDiagnostics.from_state_dict(
        json.loads(json.dumps(ours.state_dict())))
    for sd in (ours, ref, ours_from_ref, ref_from_ours):
        sd.fold(b)
    for sd in (ref, ours_from_ref, ref_from_ours):
        np.testing.assert_array_equal(ours.split_rhat(), sd.split_rhat())
        np.testing.assert_array_equal(ours.ess(), sd.ess())
        _assert_same_state(ours.state_dict(), sd.state_dict())


@pytest.mark.parametrize("until", [
    dict(max_rhat=1.05, check_every=20, batch_size=5),
    dict(max_rhat=1.3, min_ess=60.0, check_every=20, batch_size=5),
    dict(max_rhat=None, min_ess=1e9, check_every=20, batch_size=4)])
def test_monitor_decisions_match_reference(until):
    """Gate checks over a stream whose chains start apart and mix: the
    history and the decision agree, and a monitor of either package
    re-hydrated from the other's state mid-run decides the same."""
    rng = np.random.default_rng(5)
    x = _ar1(rng, 0.5, 4, 200, 2)
    x[:, :60] += np.array([0.0, 1.5, -1.5, 3.0])[:, None, None]
    ours = mon.ConvergenceMonitor(mon.Converged(**until))
    ref = jmon.ConvergenceMonitor(jmon.Converged(**until))
    for end in range(20, 201, 20):
        ours.fold(x[:, end - 20:end])
        ref.fold(x[:, end - 20:end])
        assert ours.check(end) == ref.check(end)
        if end == 100:
            ours_from_ref = mon.ConvergenceMonitor(ours.until)
            ours_from_ref.load_state_dict(json.loads(json.dumps(
                ref.state_dict())))
            ref_from_ours = jmon.ConvergenceMonitor(ref.until)
            ref_from_ours.load_state_dict(json.loads(json.dumps(
                ours.state_dict())))
        elif end > 100:
            ours_from_ref.fold(x[:, end - 20:end])
            ref_from_ours.fold(x[:, end - 20:end])
            assert ours_from_ref.check(end) == ref_from_ours.check(end)
    ours.exhausted(200)
    ref.exhausted(200)
    for other in (ref, ours_from_ref, ref_from_ours):
        other.exhausted(200)
        assert json.dumps(other.decision) == json.dumps(ours.decision)
        assert json.dumps(other.history[-1]) == json.dumps(
            ours.history[-1])
    assert json.dumps(ours.history) == json.dumps(ref.history)


def test_converged_satisfied_nan_matches_reference():
    values = [float("nan"), 0.5, 1.0, 1.01, 11.0, 100.0, float("inf")]
    for kw in (dict(max_rhat=10.0, min_ess=1.0), dict(max_rhat=10.0,
                                                      min_ess=None),
               dict(max_rhat=None, min_ess=50.0)):
        for r in values:
            for e in values:
                assert mon.Converged(**kw).satisfied(r, e) \
                    == jmon.Converged(**kw).satisfied(r, e), (kw, r, e)
    assert not mon.Converged(max_rhat=10.0, min_ess=1.0).satisfied(
        float("nan"), 100.0)
    assert mon.Converged()._fields == jmon.Converged()._fields
    assert tuple(mon.Converged()) == tuple(jmon.Converged())


# ---------------------------------------------------------------------------
# RPL403
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(max_rhat=None, min_ess=None),
    dict(max_rhat=0.99),
    dict(min_ess=10_000.0),
    dict(batch_size=1),
    dict(check_every=0),
    dict(max_samples=0),
    dict(batch_size=30),
    dict(max_rhat=1.01, min_ess=100.0, check_every=50, batch_size=10),
])
def test_rpl403_findings_match_reference(kw):
    ours = verify_until(Converged(**kw), num_samples=100, num_chains=4)
    ref = j_verify_until(jmon.Converged(**kw), num_samples=100,
                         num_chains=4)
    assert [(f.code, f.severity, f.site, f.message) for f in ours.findings] \
        == [(f.code, f.severity, f.site, f.message) for f in ref.findings]
    assert ours.ok == ref.ok
    assert ours.ok == ("min_ess" in kw and kw["min_ess"] == 100.0)


def model():
    pc.sample("x", dist.Normal(1.0, 2.0))


def funnel():
    v = pc.sample("v", dist.Normal(0.0, 3.0))
    pc.sample("x", dist.Normal(0.0, torch.exp(0.5 * v)))


KERNELS = {
    "NUTS1": (lambda: NUTS(model, device="cpu"), 1),
    "NUTS4": (lambda: NUTS(model, device="cpu"), 4),
    "HMC2": (lambda: HMC(model, device="cpu"), 2),
    "cross_chain": (lambda: NUTS(model, cross_chain_adapt=True,
                                 device="cpu"), 4),
    "ChEES": (lambda: ChEES(model, device="cpu"), 4),
    "MALA": (lambda: MALA(model, device="cpu"), 4),
    "RWM": (lambda: RWM(model, device="cpu"), 4),
}


def _mcmc(name, samples=SAMPLES, **kw):
    make, chains = KERNELS[name]
    return MCMC(make(), WARMUP, samples, num_chains=chains, **kw)


def test_run_rejects_bad_gates_before_the_first_transition():
    calls = []
    kernel = NUTS(model, device="cpu")
    real_setup = kernel.setup

    def setup(*args, **kwargs):
        calls.append(1)
        return real_setup(*args, **kwargs)

    kernel.setup = setup
    mcmc = MCMC(kernel, WARMUP, SAMPLES, num_chains=4)
    with pytest.raises(ReproValueError) as err:
        mcmc.run(0, until=Converged(max_rhat=0.5))
    assert err.value.code == "RPL403"
    with pytest.raises(TypeError):
        mcmc.run(0, until={"max_rhat": 1.01})
    seq = MCMC(NUTS(model, device="cpu"), WARMUP, SAMPLES, num_chains=2,
               chain_method="sequential")
    with pytest.raises(ValueError, match="sequential"):
        seq.run(0, until=Converged(max_rhat=1.01))
    assert not calls, "a rejected gate reached the kernel's setup"


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gated_run_draws_the_ungated_prefix(name):
    """A gate that fires at its first check (20 draws) stops there, and its
    draws, extra fields and the draw count are the ungated run's prefix bit
    for bit; an unreachable gate draws the whole budget bit-identically
    (lockstep NUTS and ChEES, as the reference's test)."""
    plain = _mcmc(name).run(SEED)
    gated = _mcmc(name).run(SEED, until=Converged(max_rhat=50.0,
                                                  check_every=EVERY,
                                                  batch_size=5))
    assert gated.monitor.decision["reason"] == "converged"
    assert gated.monitor.decision["stopped_at_draws"] == EVERY
    for key, value in gated._collected.items():
        assert torch.equal(value, plain._collected[key][:, :EVERY]), key
    if name not in ("NUTS4", "ChEES"):
        return
    unreachable = Converged(max_rhat=1.0 + 1e-9,
                            min_ess=float(SAMPLES * KERNELS[name][1]),
                            check_every=10, batch_size=5)
    full = _mcmc(name).run(SEED, until=unreachable)
    assert full.monitor.decision["reason"] == "max_samples"
    assert all(not h["converged"] for h in full.monitor.history)
    for key, value in full._collected.items():
        assert torch.equal(value, plain._collected[key]), key
    # the gate's draws are one read a sampling chunk over the plain run
    assert full.stats["host_syncs"] - plain.stats["host_syncs"] \
        == -(-SAMPLES // 10)


def test_max_samples_draws_past_num_samples_and_manifest_holds_decision(
        tmp_path):
    until = Converged(max_rhat=1.0 + 1e-9, min_ess=1e4, max_samples=50,
                      check_every=25, batch_size=5)
    gated = _mcmc("MALA").run(SEED, until=Converged(
        max_rhat=1.0 + 1e-9, min_ess=200.0, max_samples=50, check_every=25,
        batch_size=5))
    assert gated._collected["z"].shape[1] == 50
    assert gated.monitor.decision["reason"] == "max_samples"
    longer = _mcmc("MALA", samples=50).run(SEED)
    assert torch.equal(gated._collected["z"], longer._collected["z"])
    with pytest.raises(ReproValueError, match="RPL403"):
        _mcmc("MALA").run(SEED, until=until)
    tele = Telemetry(dir=str(tmp_path))
    run = _mcmc("MALA", telemetry=tele).run(
        SEED, until=Converged(max_rhat=50.0, check_every=EVERY,
                              batch_size=5))
    man = RunManifest.peek(os.path.join(str(tmp_path),
                                        "run_manifest.json")).data
    assert man["sessions"][-1]["final"]["convergence"] \
        == json.loads(json.dumps(run.monitor.decision))
    assert man["sessions"][-1]["final"]["done"] == WARMUP + EVERY


class _Preempted(BaseException):
    """The kill: raised from the save wrapper, caught nowhere else."""


def _run_killed(mcmc, ckdir, kill_at, until):
    real_save, calls = ckpt.save, {"n": 0}

    def wrapped(tree, directory, **kw):
        real_save(tree, directory, **kw)
        calls["n"] += 1
        if calls["n"] == kill_at:
            raise _Preempted(f"preempted after save #{kill_at}")

    ckpt.save = wrapped
    try:
        with pytest.raises(_Preempted):
            mcmc.run(SEED, checkpoint_every=EVERY, checkpoint_dir=ckdir,
                     until=until)
    finally:
        ckpt.save = real_save


@pytest.mark.parametrize("kill_at", [2, 3, 4])
def test_gated_kill_resume_identical_stopping_iteration(tmp_path, kill_at):
    """Killed during warmup (#2), after the decisive chunk's samples write
    (#3) and after its state write (#4, the decision already durable): the
    resumed run lands on the uninterrupted gated run's decision, draws and
    iteration, and draws nothing past it."""
    until = Converged(max_rhat=50.0, batch_size=5)
    ref = _mcmc("NUTS4").run(SEED, checkpoint_every=EVERY,
                             checkpoint_dir=str(tmp_path / "ref"),
                             until=until)
    assert ref.monitor.decision["reason"] == "converged"
    assert ref._collected["z"].shape[1] == EVERY
    ckdir = str(tmp_path / "kill")
    _run_killed(_mcmc("NUTS4"), ckdir, kill_at, until)
    resumed = _mcmc("NUTS4").run(SEED, checkpoint_every=EVERY,
                                 checkpoint_dir=ckdir, resume=True,
                                 until=until)
    assert torch.equal(resumed._collected["z"], ref._collected["z"])
    assert json.dumps(resumed.monitor.decision) \
        == json.dumps(ref.monitor.decision)
    assert resumed.stats["num_iterations"] == WARMUP + EVERY \
        - resumed.stats["resumed_at"]


def test_ungated_checkpoint_resumed_with_until_refolds_draws(tmp_path):
    """A checkpoint written without a gate, resumed with one after the
    first sampling chunk: the restored draws are folded, so the gate's
    accumulators are those of the whole draw stream, and the draws are the
    uninterrupted run's."""
    until = Converged(max_rhat=50.0, check_every=EVERY, batch_size=5)
    plain = _mcmc("MALA").run(SEED)
    ckdir = str(tmp_path / "kill")
    _run_killed(_mcmc("MALA"), ckdir, 4, None)
    resumed = _mcmc("MALA").run(SEED, checkpoint_every=EVERY,
                                checkpoint_dir=ckdir, resume=True,
                                until=until)
    assert resumed.stats["resumed_at"] == WARMUP + EVERY
    assert torch.equal(resumed._collected["z"], plain._collected["z"])
    assert resumed.monitor.decision["stopped_at_draws"] == SAMPLES
    whole = mon.ConvergenceMonitor(until)
    whole.fold(plain._collected["z"].numpy())
    _assert_same_state(resumed.monitor.diag.state_dict(),
                       whole.diag.state_dict())
