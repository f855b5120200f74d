"""Opt-in fused GLM potential: route a model's dominant likelihood term
through the single-pass ``ops.glm_potential_grad`` kernel.

A model opts in by marking its observed site::

    pc.sample("y", dist.Bernoulli(logits=x @ w), obs=y,
              infer={"potential": "glm"})

At setup the site's linear predictor is differentiated at zero —
``offset = predictor(0)`` and ``X`` is its Jacobian, one column per unit
vector (exact: no TF32, see :func:`_exact_fp32`) — and is verified affine
at two random probes.  The fused potential is

    potential(z) = potential_energy(block(model, hide=[site]), z) + nll(z)

with ``nll`` a ``torch.autograd.Function`` whose backward returns
``ct * grad`` from the kernel's own pass.  Any structural surprise, found
before the kernel first runs, falls back to the plain potential with a
warning: the fusion is an optimization, never a semantics change.  Once
the structure is verified, the fused and plain potentials agree by
construction, so the closing check at a probe point tests the kernel: an
error of the kernel's wrapper propagates, and a disagreement raises
``RPL503`` rather than falling back.

Eager PyTorch does not drop dead code, so re-running the model for the
prior term would also recompute the blocked site's ``x @ w`` (and record
its autograd graph) at every gradient.  The prior term therefore runs the
model with every argument whose leading dimension is the observation count
cut to zero rows; that this leaves the prior unchanged is verified at a
probe point.  Where it does not, the full arguments are used with a
warning.  The fused potential's ``glm_prior`` attribute says which
(``"slim"`` or ``"full"``).  The data-sharded fold (``data_shards``) waits
for the data-shards slice.
"""
from __future__ import annotations

import warnings
from contextlib import contextmanager

import torch

from ...kernels import ops
from ..errors import KERNEL_MISMATCH, ReproRuntimeError
from ..handlers import block, seed, substitute, trace


def _unwrap(fn):
    while hasattr(fn, "base_dist"):
        fn = fn.base_dist
    return fn


def _fallback(name, reason):
    warnings.warn(
        f"site '{name}' requested infer={{'potential': 'glm'}} but {reason}"
        "; falling back to the plain potential.", stacklevel=3)
    return None


class GlmNll(torch.autograd.Function):
    """The fused likelihood term: forward runs the kernel once for value
    and gradient, backward scales the saved gradient."""

    @staticmethod
    def forward(ctx, zflat, x, y, offset, scale, family):
        val, grad = ops.glm_potential_grad(x, y, zflat, offset, scale, family)
        ctx.save_for_backward(grad)
        return val

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return ct * grad, None, None, None, None, None


@contextmanager
def _exact_fp32():
    """float32 products in full float32: TF32 would round X to 10 bits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _design_matrix(predictor, zeros):
    """The (n, D) Jacobian of ``predictor`` at ``zeros``, one column per
    unit vector: ``g(u) = J^T u`` by one backward pass with a symbolic
    cotangent ``u``, then column ``j`` is the gradient of ``g_j`` in ``u``.
    Each column is a product with a one-hot vector, so X comes out exact."""
    z = zeros.detach().requires_grad_(True)
    with torch.enable_grad():
        pred = predictor(z)
        u = torch.zeros_like(pred, requires_grad=True)
        (g,) = torch.autograd.grad(pred, z, grad_outputs=u, create_graph=True)
        cols = [torch.autograd.grad(g[j], u, retain_graph=True)[0]
                for j in range(z.numel())]
    return torch.stack(cols, dim=1).contiguous()


def _slim(value, n):
    """``value`` with every tensor whose leading dim is ``n`` cut to 0 rows."""
    if isinstance(value, torch.Tensor):
        return value[:0] if value.dim() >= 1 and value.shape[0] == n else value
    if isinstance(value, (tuple, list)):
        return type(value)(_slim(v, n) for v in value)
    if isinstance(value, dict):
        return {k: _slim(v, n) for k, v in value.items()}
    return value


def _close(a, b, rtol):
    return bool(torch.abs(a - b) <= rtol * (1.0 + torch.abs(b)))


def maybe_fuse_glm_potential(model, model_args, model_kwargs, transforms,
                             unravel_fn, flat_proto, model_trace,
                             potential_flat):
    """Return a fused flat potential function, or None to keep the plain
    one.  Verification runs on concrete tensors at setup time."""
    marked = [name for name, site in model_trace.items()
              if site["type"] == "sample" and site["is_observed"]
              and site["infer"].get("potential") == "glm"]
    if not marked:
        return None
    if len(marked) > 1:
        return _fallback(marked[0], f"{len(marked)} sites are marked "
                         "(only a single GLM likelihood can be fused)")
    name = marked[0]
    site = model_trace[name]
    if site["scale"] is not None or site["mask"] is not None:
        return _fallback(name, "the site carries a scale/mask modifier "
                         "(subsampled plate or mask handler)")
    fn = _unwrap(site["fn"])
    kind = type(fn).__name__
    if kind == "Bernoulli":
        if fn.logits is None:
            return _fallback(name, "the Bernoulli is probs-parametrized "
                             "(fusion needs the logits parametrization)")
        family, read = "bernoulli_logit", lambda d: _unwrap(d).logits
    elif kind == "Normal":
        family, read = "normal", lambda d: _unwrap(d).loc
    else:
        return _fallback(name, f"its distribution is {kind} (supported: "
                         "Bernoulli(logits=...), Normal)")
    y = torch.as_tensor(site["value"])
    if y.dim() != 1:
        return _fallback(name, f"observations have shape {tuple(y.shape)} "
                         "(fusion expects a flat (n,) vector)")
    model_kwargs = model_kwargs or {}
    device, dtype = flat_proto.device, flat_proto.dtype

    def predictor(zflat):
        uncon = unravel_fn(zflat)
        params = {n: t(uncon[n]) for n, t in transforms.items()}
        with block():
            tr = trace(substitute(seed(model, 0), data=params)) \
                .get_trace(*model_args, **model_kwargs)
        return torch.as_tensor(read(tr[name]["fn"])).to(torch.float32), \
            tr[name]["fn"]

    def probe(seed_value):
        gen = torch.Generator().manual_seed(seed_value)
        return (torch.randn(flat_proto.shape, generator=gen, dtype=dtype)
                * 0.5).to(device)

    try:
        with _exact_fp32():
            zeros = torch.zeros_like(flat_proto)
            offset, fn0 = predictor(zeros)
            if tuple(offset.shape) != tuple(y.shape):
                return _fallback(name, f"its predictor has shape "
                                 f"{tuple(offset.shape)}, the observations "
                                 f"{tuple(y.shape)}")
            x = _design_matrix(lambda z: predictor(z)[0], zeros)
            scale = None
            if family == "normal":
                s = torch.as_tensor(_unwrap(fn0).scale)
                if s.numel() > 1 and not bool(torch.all(s == s.reshape(-1)[0])):
                    return _fallback(name, "the Normal scale varies across "
                                     "observations (kernel takes one scalar)")
                scale = float(s.reshape(-1)[0])
            # verify affinity (and scale constancy) at two random probes
            for k in (1, 11):
                z = probe(k)
                pred, fnz = predictor(z)
                lin = x @ z.to(x.dtype) + offset
                tol = 1e-4 * (1.0 + float(torch.max(torch.abs(lin))))
                if not bool(torch.all(torch.abs(pred - lin) <= tol)):
                    return _fallback(name, "its predictor is not affine in "
                                     "the unconstrained latents")
                if family == "normal" and not bool(torch.all(
                        torch.as_tensor(_unwrap(fnz).scale) == s)):
                    return _fallback(name, "the Normal scale depends on the "
                                     "latents")
    except Exception as e:  # noqa: BLE001 — tracing surprises => plain path
        return _fallback(name, f"predictor extraction failed "
                         f"({type(e).__name__}: {e})")

    from .util import potential_energy
    x = x.to(torch.float32).contiguous()
    y32 = y.to(torch.float32).contiguous()
    offset = offset.contiguous()
    prior_model = block(model, hide=[name])
    n = y.shape[0]
    zp = probe(2)

    def prior_energy(zflat, args, kwargs):
        return potential_energy(prior_model, args, kwargs, transforms,
                                unravel_fn(zflat))

    prior_inputs = (_slim(model_args, n), _slim(model_kwargs, n))
    try:
        slim_ok = _close(prior_energy(zp, *prior_inputs),
                         prior_energy(zp, model_args, model_kwargs), 1e-6)
        why = "its prior term changes when the data are cut to 0 rows"
    except Exception as e:  # noqa: BLE001 — the model needs its full data
        slim_ok = False
        why = (f"its prior term fails on data cut to 0 rows "
               f"({type(e).__name__}: {e})")
    if not slim_ok:
        warnings.warn(
            f"site '{name}' is fused but {why}; every gradient re-runs the "
            "model on the full arguments.", stacklevel=2)
        prior_inputs = (model_args, model_kwargs)

    def fused_potential(zflat):
        return (prior_energy(zflat, *prior_inputs)
                + GlmNll.apply(zflat, x, y32, offset, scale, family))

    fused_potential.glm_prior = "slim" if slim_ok else "full"
    # end-to-end verification: fused == plain at a probe point.  Not caught:
    # a build or launch error of the kernel propagates.
    a, b = fused_potential(zp), potential_flat(zp)
    if not _close(a, b, 1e-4):
        raise ReproRuntimeError(
            f"site '{name}': the fused GLM potential disagrees with the plain "
            f"one at a probe point ({float(a)} vs {float(b)}) on "
            f"{x.device}: ops.glm_potential_grad is at fault.",
            code=KERNEL_MISMATCH, site=name)
    return fused_potential
