"""The port's ``enum_chain`` (``markov``'s T-1 contractions in one op)
against the JAX package's ``lax.scan`` of ``enum_contract``, on the same
numpy inputs:

- ``enum_chain_ref`` and ``EnumChain`` on the CPU against the scan of
  ``repro.kernels.ref.enum_contract`` (and once of the Pallas kernel in
  interpret mode), within ``TOL`` of ``test_torch_enum.py`` relative to
  each value, ``-inf`` where the reference has it;
- ``EnumChain``'s values and both gradients bit for bit those of a loop of
  ``EnumContract`` calls, which is what ``markov`` ran before the chain;
- its gradients against ``jax.grad`` of the scan within ``GRAD_TOL``,
  ``gradcheck`` in float64, and exact zeros (not NaN) where a state or a
  column is masked with ``-inf``.

The chain kernels themselves are tested in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from repro.kernels import ref as jref
from repro.kernels.enum_contract import enum_contract as j_enum_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.enum_contract import (EnumChain, EnumContract,
                                               enum_chain_bwd_ref,
                                               enum_chain_ref)

TOL = 1e-6  # test_torch_enum.py's float32 bound, here relative to |value|:
#             alpha grows ~3 a step, and each step rounds once in each package
GRAD_TOL = 1e-5  # test_torch_enum.py's gradient bound


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are tiny: intra-op threads only add contention."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(T, batch, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(batch + (k,)).astype(dtype),
            rng.standard_normal((T - 1,) + batch + (k, k)).astype(dtype))


def _masked():
    """A -inf state in alpha0 and a -inf column at two steps, the last
    giving a -inf entry of alpha_T."""
    a, m = _inputs(6, (), 4, 11)
    a[1] = -np.inf
    m[2][:, 3] = -np.inf
    m[-1][:, 2] = -np.inf
    return a, m


def _j_chain(a, m, contract=jref.enum_contract):
    def step(alpha, mat):
        return contract(alpha, mat), None

    return lax.scan(step, a, m)[0]


def _assert_close(ours, theirs, tol):
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(theirs))
    finite = np.isfinite(theirs)
    np.testing.assert_allclose(ours[finite], theirs[finite], rtol=tol,
                               atol=tol)


CASES = ([(T, (), k) for T in (1, 2, 12, 40) for k in (2, 3, 8, 33)]
         + [(12, (4,), 8), (40, (4,), 3), (12, (2, 3), 5)])


@pytest.mark.parametrize("T,batch,k", CASES + [(6, "masked", 4)])
def test_enum_chain_matches_jax_scan(T, batch, k):
    a, m = _masked() if batch == "masked" else _inputs(T, batch, k, T * k)
    alphas = enum_chain_ref(torch.from_numpy(a), torch.from_numpy(m))
    assert alphas.shape == (T,) + a.shape and torch.equal(
        alphas[0], torch.from_numpy(a))
    out = EnumChain.apply(torch.from_numpy(a), torch.from_numpy(m))
    assert torch.equal(out, alphas[-1])
    assert torch.equal(ops.enum_chain(torch.from_numpy(a),
                                      torch.from_numpy(m)), out)
    theirs = _j_chain(jnp.asarray(a), jnp.asarray(m))
    _assert_close(out.numpy(), theirs, TOL)
    if batch == "masked":
        assert bool(torch.isneginf(out[2])) and torch.isfinite(out[:2]).all()


def test_enum_chain_matches_pallas_scan():
    a, m = _inputs(12, (4,), 8, 5)
    out = EnumChain.apply(torch.from_numpy(a), torch.from_numpy(m))
    theirs = _j_chain(jnp.asarray(a), jnp.asarray(m),
                      lambda x, y: j_enum_pallas(x, y, interpret=True))
    _assert_close(out.numpy(), theirs, TOL)


def _loop(a, m):
    """markov's elimination before the chain: one EnumContract per step."""
    alpha = a
    for mat in torch.unbind(m, 0):
        alpha = EnumContract.apply(alpha, mat)
    return alpha


@pytest.mark.parametrize("a_shape,m_shape", [
    ((8,), (11, 8, 8)), ((4, 3), (5, 4, 3, 3)), ((2, 3, 5), (7, 2, 3, 5, 5)),
    ((5,), (6, 3, 5, 5)), ((2, 1, 4), (4, 3, 4, 4)),
    ((1, 4), (3, 2, 1, 4, 4)), ((3,), (1, 3, 3))])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_enum_chain_equals_enum_contract_loop_bit_for_bit(a_shape, m_shape,
                                                          dtype):
    rng = np.random.default_rng(len(m_shape) + m_shape[0])
    a = rng.standard_normal(a_shape).astype(dtype)
    m = rng.standard_normal(m_shape).astype(dtype)
    results = []
    for fn in (_loop, EnumChain.apply):
        at, mt = (torch.from_numpy(v).requires_grad_(True) for v in (a, m))
        out = fn(at, mt)
        g = torch.from_numpy(np.random.default_rng(1).standard_normal(
            tuple(out.shape)).astype(dtype))
        (out * g).sum().backward()
        results.append((out.detach(), at.grad, mt.grad))
    for ours, theirs in zip(*results):
        assert ours.dtype == theirs.dtype and torch.equal(ours, theirs)


def test_enum_chain_of_one_state_returns_alpha0():
    a = torch.randn(2, 3, dtype=torch.float64, requires_grad=True)
    m = torch.zeros(0, 2, 3, 3, dtype=torch.float64, requires_grad=True)
    out = EnumChain.apply(a, m)
    assert torch.equal(out, a)
    out.sum().backward()
    assert torch.equal(a.grad, torch.ones_like(a))
    assert m.grad.shape == m.shape
    d_a, d_m = enum_chain_bwd_ref(m.detach(), a.detach()[None],
                                  torch.ones(2, 3, dtype=torch.float64))
    assert torch.equal(d_a, torch.ones(2, 3, dtype=torch.float64))
    assert d_m.shape == m.shape


@pytest.mark.parametrize("T,batch,k", [(2, (), 3), (12, (), 8), (40, (), 3),
                                       (12, (4,), 8), (12, (2, 3), 5)])
def test_enum_chain_grad_matches_jax_grad(T, batch, k):
    a, m = _inputs(T, batch, k, 7 + T + k)
    g = np.random.default_rng(k).standard_normal(batch + (k,)).astype(
        np.float32)
    at, mt = (torch.from_numpy(v).requires_grad_(True) for v in (a, m))
    (EnumChain.apply(at, mt) * torch.from_numpy(g)).sum().backward()
    ja, jm = jax.grad(lambda x, y: jnp.sum(_j_chain(x, y) * g),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(m))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ja),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(jm),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("a_shape,m_shape", [((3,), (4, 3, 3)),
                                             ((2, 1, 3), (3, 4, 3, 3)),
                                             ((4,), (2, 2, 4, 4))])
def test_enum_chain_gradcheck_f64(a_shape, m_shape):
    rng = np.random.default_rng(len(m_shape))
    a = torch.from_numpy(rng.standard_normal(a_shape)).requires_grad_(True)
    m = torch.from_numpy(rng.standard_normal(m_shape)).requires_grad_(True)
    assert torch.autograd.gradcheck(EnumChain.apply, (a, m))


def test_enum_chain_masked_gradients_are_zero():
    a, m = (torch.from_numpy(v).requires_grad_(True) for v in _masked())
    out = EnumChain.apply(a, m)
    assert bool(torch.isneginf(out[2]))
    out[torch.isfinite(out)].sum().backward()
    for grad in (a.grad, m.grad):
        assert not torch.isnan(grad).any()
    assert float(a.grad[1]) == 0.0
    assert float(m.grad[0][1].abs().max()) == 0.0   # from the -inf state
    assert float(m.grad[2][:, 3].abs().max()) == 0.0
    assert float(m.grad[3][3].abs().max()) == 0.0   # alpha_3[3] is -inf
    assert float(m.grad[-1][:, 2].abs().max()) == 0.0
    # the plain backward alone, with a nonzero cotangent on the -inf entry
    alphas = enum_chain_ref(a.detach(), m.detach())
    d_a, d_m = enum_chain_bwd_ref(m.detach(), alphas, torch.ones(4))
    assert not torch.isnan(d_a).any() and not torch.isnan(d_m).any()
    assert float(d_m[-1][:, 2].abs().max()) == 0.0


def test_enum_chain_is_registered():
    spec = ops.FUSED["enum_chain"]
    assert spec.bit_identical and spec.tol == 0.0 and spec.route == "cuda"
    assert spec.ref is enum_chain_ref
    path, line = spec.replaces.split(":")
    assert "lax.scan" in open(path).read().splitlines()[int(line) - 1]
    assert ops.BACKWARD["enum_chain_bwd"].ref is enum_chain_bwd_ref
    assert {"enum_chain", "enum_chain_bwd"} <= set(ops.launch_counts())


def test_enum_chain_rejects_malformed_shapes():
    with pytest.raises(ValueError, match="square"):
        ops.enum_chain(torch.zeros(3), torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="square"):
        ops.enum_chain(torch.zeros(4), torch.zeros(2, 3, 3))
    with pytest.raises(ValueError, match="takes"):
        ops.enum_chain(torch.zeros(3), torch.zeros(3, 3))
