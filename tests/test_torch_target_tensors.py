"""The port's derivative accessors against klara_tpu's on the swiss target
(200 x 4, 12 positions from a numpy seed), in both ``ad_mode``s, f32, rtol
1e-4: ``grad_loglikelihood``, ``grad_logprior``, ``tensor``,
``tensor_loglikelihood``, ``tensor_logprior``, ``dtensor``,
``dtensor_loglikelihood``, ``dtensor_logprior`` and
``logdensity_grad_tensor``; then the ``tensor_fn`` / ``dtensor_fn`` overrides,
a ``prior`` object in place of ``logprior_fn``, and the whitened tensor."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu import distributions as jd
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch import distributions as td
from klara_tpu_torch.models import examples as tex

C, D = 12, 4
P = (0.5 * np.random.default_rng(0).standard_normal((C, D))).astype(np.float32)
ACCESSORS = [
    ("grad_loglikelihood", (C, D)),
    ("grad_logprior", (C, D)),
    ("tensor", (C, D, D)),
    ("tensor_loglikelihood", (C, D, D)),
    ("tensor_logprior", (C, D, D)),
    ("dtensor", (C, D, D, D)),
    ("dtensor_loglikelihood", (C, D, D, D)),
    ("dtensor_logprior", (C, D, D, D)),
]


def _close(a, b, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _targets(ad_mode):
    jt = dataclasses.replace(jex.swiss_logistic_regression()[0], ad_mode=ad_mode)
    tt = dataclasses.replace(tex.swiss_logistic_regression(device="cpu")[0], ad_mode=ad_mode)
    return jt, tt


@pytest.mark.parametrize("ad_mode", ["reverse", "forward"])
@pytest.mark.parametrize("name,shape", ACCESSORS)
def test_accessor_matches_jax_on_swiss(name, shape, ad_mode):
    jt, tt = _targets(ad_mode)
    ref = jax.vmap(getattr(jt, name))(jnp.asarray(P))
    out = getattr(tt, name)(torch.tensor(P))
    assert tuple(out.shape) == shape
    _close(out, ref)


@pytest.mark.parametrize("ad_mode", ["reverse", "forward"])
def test_logdensity_grad_tensor_matches_jax_on_swiss(ad_mode):
    """Value and gradient come from the fused value+grad (the plain version
    of the kernel on the CPU), the tensor from the Hessian of logdensity_fn."""
    jt, tt = _targets(ad_mode)
    rv, rg, rt = jax.vmap(jt.logdensity_grad_tensor)(jnp.asarray(P))
    v, g, t = tt.logdensity_grad_tensor(torch.tensor(P))
    _close(v, rv)
    _close(g, rg)
    _close(t, rt)
    # the tensor is the sum of its two parts
    _close(t, tt.tensor_loglikelihood(torch.tensor(P)) + tt.tensor_logprior(torch.tensor(P)))


def test_tensor_goes_through_logdensity_fn_not_the_fused_kernel():
    _, tt = _targets("reverse")

    def boom(x):
        raise AssertionError("the Hessian must not trace value_and_grad_fn")

    tt = dataclasses.replace(tt, value_and_grad_fn=boom, grad_fn=boom)
    assert tt.tensor(torch.tensor(P)).shape == (C, D, D)
    assert tt.dtensor(torch.tensor(P)).shape == (C, D, D, D)


def test_tensor_and_dtensor_overrides():
    prec = np.diag([1.0, 2.0, 3.0, 4.0]).astype(np.float32)
    tp = torch.tensor(prec)
    tt = kt.Target(
        logdensity_fn=lambda x: -0.5 * ((x @ tp) * x).sum(-1), dim=D,
        grad_fn=lambda x: -(x @ tp),
        tensor_fn=lambda x: tp.expand(x.shape[0], D, D) * (1.0 + x[:, :1, None]),
    )
    x = torch.tensor(P)
    torch.testing.assert_close(tt.tensor(x), tp * (1.0 + x[:, :1, None]))
    # dtensor differentiates the override: only ∂/∂x_0 is non-zero
    dt = tt.dtensor(x)
    torch.testing.assert_close(dt[..., 0], tp.expand(C, D, D))
    assert float(dt[..., 1:].abs().max()) == 0.0
    v, g, t = tt.logdensity_grad_tensor(x)
    torch.testing.assert_close(t, tt.tensor(x))
    torch.testing.assert_close(g, -(x @ tp))
    tt2 = dataclasses.replace(tt, dtensor_fn=lambda x: torch.ones(x.shape[0], D, D, D))
    assert float(tt2.dtensor(x).min()) == 1.0
    # whitening carries the analytic tensor: H_y = Lᵀ H_x L
    L = torch.tensor(np.linalg.cholesky(np.linalg.inv(prec)).astype(np.float32))
    wt = kt.whiten_target(tt, L)
    torch.testing.assert_close(wt.tensor(x), L.T @ tt.tensor(x @ L.T) @ L)


def test_prior_object_backs_the_logprior_accessors():
    jt = jkt.Target(lambda x: -0.5 * jnp.sum(x * x), dim=D, prior=jd.Normal(0.5, 2.0))
    tt = kt.Target(lambda x: -0.5 * (x * x).sum(-1), dim=D, prior=td.Normal(0.5, 2.0))
    x = torch.tensor(P)
    _close(tt.grad_logprior(x), jax.vmap(jt.grad_logprior)(jnp.asarray(P)))
    _close(tt.tensor_logprior(x), jax.vmap(jt.tensor_logprior)(jnp.asarray(P)))
    with pytest.raises(ValueError, match="loglikelihood"):
        tt.tensor_loglikelihood(x)
    with pytest.raises(ValueError, match="logprior"):
        kt.Target(lambda x: x.sum(-1)).grad_logprior(x)
