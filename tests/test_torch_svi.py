"""The port's SVI (``Trace_ELBO``, ``SVI``, ``SVIState``, ``AutoNormal``)
against the JAX package's, on the same numpy inputs:

- level 1: ``Trace_ELBO.loss`` and its gradient in every param at fixed
  params, the guide's base draws the reference's (recovered from its keys
  and injected into the port's ``Normal.sample``), within 1e-10 in float64
  and 1e-5 (relative) in float32, with full-size plates and with a
  subsampled plate whose indices are pinned through ``substitute``;
  ``AutoNormal``'s param names, shapes, init values and ``median``;
- level 2: one ``SVI.update`` (1 and 4 particles) from the reference's
  state (``interop.svi_state_from_reference``) with its base draws
  injected: params and Adam state within 1e-10 in float64;
- level 3: ``tests/test_svi_minibatch.py``'s recovery, unbiasedness,
  guard and ``evaluate`` tests and ``tests/test_vmap_compose.py``'s
  multi-particle ELBO tests, each on the port with the reference's gates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import random

import repro.core as jpc
from repro import optim as joptim
from repro.core import dist as jdist
from repro.core.handlers import seed as j_seed
from repro.core.handlers import substitute as j_substitute
from repro.core.handlers import trace as j_trace
from repro.core.infer import SVI as JSVI
from repro.core.infer import AutoNormal as JAutoNormal
from repro.core.infer import Trace_ELBO as JTrace_ELBO
from repro_torch import core as pc
from repro_torch import optim
from repro_torch.bench.models import svi_logreg_model
from repro_torch.core import dist
from repro_torch.core.dist import continuous
from repro_torch.core.errors import ReproError
from repro_torch.core.handlers import scope, substitute
from repro_torch.core.infer import SVI, AutoNormal, SVIState, Trace_ELBO
from repro_torch.interop import svi_state_from_reference

N, D = 20, 3


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _regression_data(dtype, n=N):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, D)).astype(dtype)
    y = (x @ np.array([1.0, -0.5, 0.25]) + 0.3 * rng.standard_normal(n)
         ).astype(dtype)
    return x, y


# a continuous regression with a constrained global and a local latent in a
# full-size plate
def j_local_model(x, y):
    m = jpc.sample("m", jdist.Normal(0.0, jnp.ones(D)).to_event(1))
    s = jpc.sample("s", jdist.HalfNormal(1.0))
    with jpc.plate("N", x.shape[0]):
        z = jpc.sample("z", jdist.Normal(0.0, s))
        jpc.sample("y", jdist.Normal(x @ m + z, 1.0), obs=y)


def local_model(x, y):
    m = pc.sample("m", dist.Normal(x.new_zeros(()), x.new_ones(D))
                  .to_event(1))
    s = pc.sample("s", dist.HalfNormal(x.new_ones(())))
    with pc.plate("N", x.shape[0]):
        z = pc.sample("z", dist.Normal(x.new_zeros(()), s))
        pc.sample("y", dist.Normal(x @ m + z, 1.0), obs=y)


def _j_logreg(n, subsample_size):
    """benchmarks/svi_minibatch.py's model in the JAX package."""
    def model(x, y=None):
        m = jpc.sample("m", jdist.Normal(0.0, 1.0).expand((x.shape[-1],))
                       .to_event(1))
        b = jpc.sample("b", jdist.Normal(0.0, 1.0))
        with jpc.plate("N", n, subsample_size=subsample_size):
            xb = jpc.subsample(x, event_dim=1)
            yb = jpc.subsample(y, event_dim=0) if y is not None else None
            jpc.sample("y", jdist.Bernoulli(logits=xb @ m + b), obs=yb)
    return model


def _logreg_data(n, dtype=np.float32):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, D)).astype(dtype)
    p = 1.0 / (1.0 + np.exp(-(x @ np.array([1.0, 2.0, 3.0]))))
    return x, (rng.random(n) < p).astype(dtype)


def _guide_sites(guide, *args):
    """The latent names of an AutoNormal in its order."""
    guide._setup(*args)
    return list(guide._transforms)


def _j_base_draws(j_guide, names, key_loss, particles, args):
    """The reference's standard-normal base draws of one ``Trace_ELBO``
    loss: per particle (``split(key_loss, P)``, or ``key_loss`` alone), the
    guide's key (``split(key)[1]``) seeds the guide with every loc 0 and
    every log-scale 0, so each base site's value is its draw exactly."""
    keys = [key_loss] if particles == 1 else list(
        random.split(key_loss, particles))
    zero = {f"auto_{name}_{suffix}": jnp.zeros(j_guide._shapes[name])
            for name in names for suffix in ("loc", "scale")}
    out = []
    for key in keys:
        key_guide = random.split(key)[1]
        # seed innermost, as in log_density: it splits for the params too
        tr = j_trace(j_substitute(j_seed(j_guide, key_guide), data=zero)
                     ).get_trace(*args)
        out += [np.asarray(tr[f"auto_{n}_base"]["value"]) for n in names]
    return out


@pytest.fixture
def inject(monkeypatch):
    """``inject(draws)``: the port's ``Normal.sample`` returns ``loc + scale
    * eps`` with ``eps`` the next of ``draws`` (a list it empties)."""
    def install(draws):
        def sample(self, generator=None, sample_shape=()):
            eps = torch.from_numpy(np.array(draws.pop(0)))
            loc = torch.as_tensor(self.loc)
            return self.loc + self.scale * eps.to(loc.dtype)
        monkeypatch.setattr(continuous.Normal, "sample", sample)
    return install


def _params(names, shapes, dtype, seed_):
    rng = np.random.default_rng(seed_)
    out = {}
    for name in names:
        out[f"auto_{name}_loc"] = np.asarray(
            0.3 * rng.standard_normal(shapes[name]), dtype)
        out[f"auto_{name}_scale"] = np.asarray(np.log(rng.uniform(
            0.1, 0.5, shapes[name])), dtype)
    return out


CASES = ["local", "subsampled"]


def _case(case, dtype):
    """(j_model, port model, data, pinned plate indices or None)."""
    if case == "local":
        return j_local_model, local_model, _regression_data(dtype), None
    x, y = _logreg_data(N, dtype)
    idx = np.random.default_rng(7).permutation(N)[:6]
    return (j_substitute(_j_logreg(N, 6), data={"N": jnp.asarray(idx)}),
            substitute(svi_logreg_model(N, 6),
                       data={"N": torch.from_numpy(idx)}), (x, y), idx)


@pytest.mark.parametrize("particles", [1, 3])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("case", CASES)
def test_trace_elbo_loss_and_gradient_match_reference(case, dtype, tol,
                                                      particles, inject):
    j_model, model, data, _ = _case(case, dtype)
    with jax.enable_x64(dtype == np.float64):
        j_guide = JAutoNormal(j_model)
        names = _guide_sites(j_guide, *map(jnp.asarray, data))
        shapes = {n: tuple(j_guide._shapes[n]) for n in names}
        params = _params(names, shapes, dtype, 1)
        key = random.PRNGKey(5)
        elbo = JTrace_ELBO(particles)
        jargs = tuple(map(jnp.asarray, data))
        want, want_g = jax.jit(jax.value_and_grad(
            lambda p: elbo.loss(key, p, j_model, j_guide, *jargs)))(
            {k: jnp.asarray(v) for k, v in params.items()})
        draws = _j_base_draws(j_guide, names, key, particles, jargs)
    guide = AutoNormal(model)
    targs = tuple(map(torch.from_numpy, data))
    assert _guide_sites(guide, *targs) == names
    inject(draws)
    tparams = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in params.items()}
    got = Trace_ELBO(particles).loss(torch.Generator().manual_seed(0),
                                     tparams, model, guide, *targs)
    grads = torch.autograd.grad(got, list(tparams.values()))
    assert not draws  # every injected draw was taken
    assert got.dtype == torch.from_numpy(data[0]).dtype
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=tol,
                               atol=tol)
    for (name, _), g in zip(tparams.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[name]),
                                   rtol=tol, atol=tol, err_msg=name)


def test_autonormal_params_and_median_match_reference():
    x, y = _regression_data(np.float32)
    jsvi = JSVI(j_local_model, JAutoNormal(j_local_model), joptim.adam(1e-2),
                JTrace_ELBO())
    jparams = jsvi.get_params(jsvi.init(random.PRNGKey(0), jnp.asarray(x),
                                        jnp.asarray(y)))
    guide = AutoNormal(local_model)
    svi = SVI(local_model, guide, optim.adam(1e-2), Trace_ELBO(),
              device="cpu")
    params = svi.get_params(svi.init(0, torch.from_numpy(x),
                                     torch.from_numpy(y)))
    assert list(params) == list(jparams) == [
        "auto_m_loc", "auto_m_scale", "auto_s_loc", "auto_s_scale",
        "auto_z_loc", "auto_z_scale"]
    for name, value in params.items():
        assert value.shape == np.shape(jparams[name]) and \
            value.dtype == torch.float32
        np.testing.assert_array_equal(value.numpy(), np.asarray(jparams[name]))
    rand = _params(["m", "s", "z"], {"m": (D,), "s": (), "z": (N,)},
                   np.float32, 2)
    want = jsvi.guide.median({k: jnp.asarray(v) for k, v in rand.items()})
    got = guide.median({k: torch.from_numpy(v) for k, v in rand.items()})
    assert list(got) == list(want) == ["m", "s", "z"]
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6)
    draws = guide.sample_posterior(torch.Generator().manual_seed(0),
                                   params, num_samples=5)
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        "m": (5, D), "s": (5,), "z": (5, N)}
    assert bool((draws["s"] > 0).all())


def _j_update(jsvi, state, args):
    """The reference's ``SVI.update`` (src/repro/core/infer/svi.py:105-116)
    with its loss gradient jitted (float64, fast) and its Adam step eager:
    under jit XLA may fuse Adam's float32 products into FMAs."""
    key, key_loss = random.split(state.rng_key)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jsvi.loss.loss(key_loss, p, jsvi.model, jsvi.guide,
                                 *args)))(state.params)
    updates, opt_state = jsvi.optim.update(grads, state.opt_state,
                                           state.params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, state.params,
                                    updates)
    return type(state)(params, opt_state, key), loss


def _strong_f64(tree):
    return {k: jnp.asarray(v, dtype=jnp.float64) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_adam_update_bitwise_matches_reference(dtype):
    """The port's ``optim.adam`` step equals the JAX package's bit for bit
    on 20,000 moments over five decades of gradient: the float32 square
    root is the correctly rounded one on both sides."""
    rng = np.random.default_rng(3)
    n = 20_000
    g = (rng.standard_normal(n) * 10 ** rng.uniform(-4, 1, n)).astype(dtype)
    m = (0.1 * rng.standard_normal(n)).astype(dtype)
    v = (0.1 * rng.uniform(size=n)).astype(dtype)
    with jax.enable_x64(True):
        j_up, j_st = joptim.adam(5e-2).update(
            {"a": jnp.asarray(g)}, joptim.optimizers.AdamState(
                jnp.asarray(4, jnp.int32), {"a": jnp.asarray(m)},
                {"a": jnp.asarray(v)}))
        j_up, j_st = jax.device_get((j_up, j_st))
    p_up, p_st = optim.adam(5e-2).update(
        {"a": torch.from_numpy(g)}, optim.optimizers.AdamState(
            4, {"a": torch.from_numpy(m)}, {"a": torch.from_numpy(v)}))
    assert p_st.count == int(j_st.count) == 5
    np.testing.assert_array_equal(p_st.mu["a"].numpy(), j_st.mu["a"])
    np.testing.assert_array_equal(p_st.nu["a"].numpy(), j_st.nu["a"])
    np.testing.assert_array_equal(p_up["a"].numpy(), j_up["a"])


@pytest.mark.parametrize("particles", [1, 4])
def test_svi_update_from_reference_state_matches(particles, inject):
    x, y = _regression_data(np.float64)
    with jax.enable_x64(True):
        j_guide = JAutoNormal(j_local_model)
        jsvi = JSVI(j_local_model, j_guide, joptim.adam(5e-2),
                    JTrace_ELBO(particles))
        jargs = (jnp.asarray(x), jnp.asarray(y))
        state = jsvi.init(random.PRNGKey(1), *jargs)
        state, _ = jax.jit(jsvi.update)(state, *jargs)  # with moments
        # under x64 the reference's log-scale params start weakly typed, so
        # its first update turns them float32 (weak float64 + float32
        # update); hold both packages in float64 throughout
        state = state._replace(
            params=_strong_f64(state.params),
            opt_state=state.opt_state._replace(
                mu=_strong_f64(state.opt_state.mu),
                nu=_strong_f64(state.opt_state.nu)))
        key_loss = random.split(state.rng_key)[1]
        names = _guide_sites(j_guide, *jargs)
        draws = _j_base_draws(j_guide, names, key_loss, particles, jargs)
        want, want_loss = _j_update(jsvi, state, jargs)
        state, want = jax.device_get(state), jax.device_get(want)
    port_state = svi_state_from_reference(state)
    assert port_state.opt_state.count == 1
    svi = SVI(local_model, AutoNormal(local_model), optim.adam(5e-2),
              Trace_ELBO(particles), device="cpu")
    targs = (torch.from_numpy(x), torch.from_numpy(y))
    _guide_sites(svi.guide, *targs)
    inject(draws)
    before = {k: v.clone() for k, v in port_state.params.items()}
    got, loss = svi.update(port_state, *targs)
    assert not draws
    for k, v in port_state.params.items():  # update is pure
        assert torch.equal(v, before[k]) and not v.requires_grad
    assert got.opt_state.count == int(want.opt_state.count) == 2
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-10)
    for name in want.params:
        for ours, theirs in ((got.opt_state.mu, want.opt_state.mu),
                             (got.opt_state.nu, want.opt_state.nu)):
            assert ours[name].dtype == torch.float64
            np.testing.assert_allclose(ours[name].numpy(), theirs[name],
                                       rtol=1e-10, atol=1e-10,
                                       err_msg=name)
        assert got.params[name].dtype == torch.float64
        np.testing.assert_allclose(got.params[name].numpy(),
                                   want.params[name], rtol=1e-10,
                                   atol=1e-10, err_msg=name)


# ---------------------------------------------------------------------------
# level 3 and the entry points' contract
# ---------------------------------------------------------------------------

MB_N, MB_B = 600, 60


def _mb_data():
    x, y = _logreg_data(MB_N)
    return torch.from_numpy(x), torch.from_numpy(y)


def test_minibatch_matches_full_batch_coefficients():
    x, y = _mb_data()

    def fit(subsample_size, num_steps):
        model = svi_logreg_model(MB_N, subsample_size)
        guide = AutoNormal(model)
        svi = SVI(model, guide, optim.adam(5e-2), Trace_ELBO(), device="cpu")
        state, losses = svi.run(1, num_steps, x, y)
        assert losses.shape == (num_steps,)
        assert bool(torch.isfinite(losses).all())
        return guide.median(svi.get_params(state))["m"]

    m_full = fit(None, 800)
    m_mb = fit(MB_B, 1600)
    assert float((m_mb - m_full).abs().max()) < 0.5
    assert float(m_mb[2]) > float(m_mb[1]) > float(m_mb[0])


def test_minibatch_steps_draw_fresh_minibatches():
    """The counterpart of the reference's compile-once test: the same
    model code serves every step, and different minibatches give
    stochastic losses, not one cached value."""
    x, y = _mb_data()
    model = svi_logreg_model(MB_N, MB_B)
    svi = SVI(model, AutoNormal(model), optim.adam(5e-2), Trace_ELBO(),
              device="cpu")
    _, losses = svi.run(1, 60, x, y)
    assert len({round(float(v), 3) for v in losses}) > 10


def test_minibatch_elbo_unbiased_at_fixed_params():
    x, y = _mb_data()
    model_full = svi_logreg_model(MB_N)
    model_mb = svi_logreg_model(MB_N, MB_B)
    guide = AutoNormal(model_full)
    svi = SVI(model_full, guide, optim.adam(5e-2), Trace_ELBO(),
              device="cpu")
    params = svi.get_params(svi.init(1, x, y))
    elbo = Trace_ELBO()
    mb, full = [], []
    with torch.no_grad():
        for i in range(600):
            mb.append(float(elbo.loss(torch.Generator().manual_seed(i),
                                      params, model_mb, guide, x, y)))
            full.append(float(elbo.loss(torch.Generator().manual_seed(i),
                                        params, model_full, guide, x, y)))
    np.testing.assert_allclose(np.mean(mb), np.mean(full), rtol=0.03)


def _local_in_subsampled_plate(y):
    mu = pc.sample("mu", dist.Normal(y.new_zeros(()), y.new_ones(())))
    with pc.plate("N", 20, subsample_size=5):
        z = pc.sample("z", dist.Normal(mu, 1.0))
        pc.sample("obs", dist.Normal(z, 1.0),
                  obs=pc.subsample(y, event_dim=0))


def test_autonormal_rejects_local_latents_in_subsampled_plate():
    with pytest.raises(ValueError, match="local latent 'z'"):
        AutoNormal(_local_in_subsampled_plate)._setup(torch.zeros(20))


def test_autonormal_subsample_guard_survives_scope():
    guide = AutoNormal(scope(_local_in_subsampled_plate, prefix="m"))
    with pytest.raises(ValueError, match="local latent 'm/z'"):
        guide._setup(torch.zeros(20))


def test_svi_evaluate_matches_next_update_loss():
    x, y = _mb_data()
    model = svi_logreg_model(MB_N, MB_B)
    svi = SVI(model, AutoNormal(model), optim.adam(5e-2), Trace_ELBO(),
              device="cpu")
    state = svi.init(1, x, y)
    for _ in range(3):
        preview = svi.evaluate(state, x, y)
        rng = state.rng.clone()
        state, loss = svi.update(state, x, y)
        assert float(preview) == float(loss)
        assert not torch.equal(state.rng, rng)
    assert isinstance(state, SVIState)


def _vc_data(n=80):
    x, y = _logreg_data(n)
    return torch.from_numpy(x), torch.from_numpy(y)


def _vc_params(x, y):
    model = svi_logreg_model(x.shape[0])
    guide = AutoNormal(model)
    svi = SVI(model, guide, optim.adam(1e-2), Trace_ELBO(), device="cpu")
    return model, guide, svi.get_params(svi.init(0, x, y))


def test_multi_particle_elbo_is_the_mean_of_singles():
    """tests/test_vmap_compose.py's App. D test: the multi-particle ELBO
    equals the mean of single-particle ELBOs on the same sub-generators."""
    from repro_torch.core.infer.hmc_util import split_draws
    x, y = _vc_data()
    model, guide, params = _vc_params(x, y)
    with torch.no_grad():
        vec = Trace_ELBO(16).loss(torch.Generator().manual_seed(1), params,
                                  model, guide, x, y)
        draws = split_draws(torch.Generator().manual_seed(1), 16)
        seq = torch.stack([Trace_ELBO().loss(d.generator, params, model,
                                             guide, x, y)
                           for d in draws]).mean()
    np.testing.assert_allclose(float(vec), float(seq), rtol=1e-6)


def test_multi_particle_elbo_variance_shrinks():
    x, y = _vc_data()
    model, guide, params = _vc_params(x, y)
    with torch.no_grad():
        def est(particles, i):
            return float(Trace_ELBO(particles).loss(
                torch.Generator().manual_seed(i), params, model, guide, x, y))

        v1 = np.var([est(1, i) for i in range(20)])
        v16 = np.var([est(16, i) for i in range(20)])
    assert v16 < v1


def test_svi_learns_logreg():
    x, y = _vc_data(300)
    model = svi_logreg_model(300)
    guide = AutoNormal(model)
    svi = SVI(model, guide, optim.adam(5e-2), Trace_ELBO(), device="cpu")
    state, _ = svi.run(1, 500, x, y)
    m = guide.median(svi.get_params(state))["m"]
    assert float(m[2]) > float(m[0])


def test_svi_entry_point_contract():
    """``validate=True`` lints model and guide in ``init`` (no longer
    ``RPL501``); the default device is the card; ``run`` with no steps gives
    an empty loss vector."""
    model = svi_logreg_model(10)
    checked = SVI(model, AutoNormal(model), optim.adam(1e-2), Trace_ELBO(),
                  validate=True, device="cpu")
    assert set(checked.init(0, *_vc_data(10)).params) == {
        "auto_m_loc", "auto_m_scale", "auto_b_loc", "auto_b_scale"}
    if not torch.cuda.is_available():
        with pytest.raises(ReproError, match="cuda"):
            SVI(model, AutoNormal(model), optim.adam(1e-2), Trace_ELBO())
    x, y = _vc_data(10)
    svi = SVI(model, AutoNormal(model), optim.adam(1e-2), Trace_ELBO(),
              device="cpu")
    state, losses = svi.run(0, 0, x.numpy(), y.numpy())  # numpy converted
    assert losses.shape == (0,) and set(state.params) == {
        "auto_m_loc", "auto_m_scale", "auto_b_loc", "auto_b_scale"}
