"""The port's Target layer against klara_tpu's on the same numpy inputs:
the logreg, swiss and normal example targets, the autograd defaults,
whiten_target and bounded_target.  JAX targets are per-chain and vmapped
here; the port's are batch-first.  f32 throughout; tolerances cover
reduction order (values are sums over up to 300 data rows)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch import convert
from klara_tpu_torch.models import examples as tex

RTOL, ATOL = 2e-5, 1e-4


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _jax_batched(target, P):
    return jax.vmap(target.logdensity_and_grad)(jnp.asarray(P))


def _logreg_data(C=6, D=4, N=300, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.4).astype(np.float32)
    P = (0.3 * rng.standard_normal((C, D))).astype(np.float32)
    return X, y, P


def test_logreg_target_matches_jax():
    X, y, P = _logreg_data()
    jt = jex.logistic_regression_target(X, y, 5.0)
    tt = convert.target_arrays(X, y, 5.0, device="cpu")
    Pt = torch.from_numpy(P)
    v_ref, g_ref = _jax_batched(jt, P)
    v, g = tt.logdensity_and_grad(Pt)  # K1's plain version
    _close(v, v_ref)
    _close(g, g_ref)
    # unfused accessors
    _close(tt.logdensity(Pt), jax.vmap(jt.logdensity)(jnp.asarray(P)))
    _close(tt.grad(Pt), jax.vmap(jt.grad)(jnp.asarray(P)))
    _close(tt.loglikelihood(Pt), jax.vmap(jt.loglikelihood)(jnp.asarray(P)))
    _close(tt.logprior(Pt), jax.vmap(jt.logprior)(jnp.asarray(P)))


def test_synthetic_and_swiss_data_match_jax():
    """Same numpy code, bit-identical data; the swiss data is read from the
    JAX package's file."""
    _, Xj, yj = jex.synthetic_logistic_regression(dim=6, n_data=50, seed=3)
    _, Xt, yt = tex.synthetic_logistic_regression(dim=6, n_data=50, seed=3, device="cpu")
    np.testing.assert_array_equal(np.asarray(Xj), Xt.numpy())
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    jt, Xj, yj = jex.swiss_logistic_regression()
    tt, Xt, yt = tex.swiss_logistic_regression(device="cpu")
    np.testing.assert_array_equal(np.asarray(Xj), Xt.numpy())
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    P = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    v_ref, g_ref = _jax_batched(jt, P)
    v, g = tt.logdensity_and_grad(torch.from_numpy(P))
    _close(v, v_ref)
    _close(g, g_ref)


def test_normal_target_matches_jax():
    x = np.random.default_rng(2).standard_normal((7, 3)).astype(np.float32)
    v_ref, g_ref = _jax_batched(jex.normal_target(3), x)
    v, g = tex.normal_target(3).logdensity_and_grad(torch.from_numpy(x))
    _close(v, v_ref, 1e-6, 1e-6)
    _close(g, g_ref, 1e-6, 1e-6)


@pytest.mark.parametrize("ad_mode", ["reverse", "forward"])
def test_autograd_default_matches_jax(ad_mode):
    """No analytic derivative: torch.autograd (reverse) or jacfwd under vmap
    (forward) against jax.grad / jax.jacfwd."""
    a = np.array([1.0, 2.0, 0.5], np.float32)

    def jll(x):
        return -jnp.sum(jnp.log(jnp.cosh(x)) * a)

    def jlp(x):
        return -0.5 * jnp.sum(x * x)

    def tll(x):
        return -(torch.log(torch.cosh(x)) * torch.from_numpy(a)).sum(-1)

    def tlp(x):
        return -0.5 * (x * x).sum(-1)

    jt = jkt.Target.from_loglik_logprior(jll, jlp, dim=3, ad_mode=ad_mode)
    tt = kt.Target.from_loglik_logprior(tll, tlp, dim=3, ad_mode=ad_mode)
    x = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    v_ref, g_ref = _jax_batched(jt, x)
    v, g = tt.logdensity_and_grad(torch.from_numpy(x))
    _close(v, v_ref, 1e-6, 1e-6)
    _close(g, g_ref, 1e-6, 1e-6)
    _close(tt.grad(torch.from_numpy(x)), g_ref, 1e-6, 1e-6)


def test_from_distribution_sums_logpdf():
    class StdNormal:
        dim = 2

        def logpdf(self, x):
            return -0.5 * x * x - 0.5 * np.log(2 * np.pi)

    x = torch.tensor([[0.0, 1.0], [2.0, -1.0]])
    t = kt.Target.from_distribution(StdNormal())
    assert t.dim == 2
    _close(t.logdensity(x), [-np.log(2 * np.pi) - 0.5, -np.log(2 * np.pi) - 2.5], 1e-6, 1e-6)
    _close(t.grad(x), -x.numpy(), 1e-6, 1e-6)


def test_whiten_target_matches_jax():
    X, y, P = _logreg_data(C=6, D=4, N=120, seed=5)
    rng = np.random.default_rng(6)
    A = rng.standard_normal((4, 4)).astype(np.float32)
    chol = np.linalg.cholesky(A @ A.T / 4 + np.eye(4, dtype=np.float32)).astype(np.float32)
    jt = jkt.whiten_target(jex.logistic_regression_target(X, y, 5.0), jnp.asarray(chol))
    tt = kt.whiten_target(convert.target_arrays(X, y, 5.0, device="cpu"), torch.from_numpy(chol))
    v_ref, g_ref = _jax_batched(jt, P)
    v, g = tt.logdensity_and_grad(torch.from_numpy(P))
    _close(v, v_ref)
    _close(g, g_ref)
    _close(tt.logdensity(torch.from_numpy(P)), jax.vmap(jt.logdensity)(jnp.asarray(P)))


def test_whitened_prior_matches_jax():
    """Both packages whiten the same base draw with the same factor."""
    draw = np.random.default_rng(7).standard_normal((8, 3)).astype(np.float32)
    chol = np.array([[2.0, 0, 0], [0.5, 1.0, 0], [-0.3, 0.2, 0.7]], np.float32)

    class Fixed:
        def __init__(self, xp):
            self.xp = xp

        def sample(self, key, shape=None):
            return self.xp.asarray(draw)

        def logpdf(self, x):
            return -0.5 * x * x

    jt = jkt.whiten_target(jkt.Target(lambda x: -0.5 * jnp.sum(x * x), dim=3, prior=Fixed(jnp)),
                           jnp.asarray(chol))
    tt = kt.whiten_target(kt.Target(lambda x: -0.5 * (x * x).sum(-1), dim=3, prior=Fixed(torch)),
                          torch.from_numpy(chol))
    # JAX's prior whitens a (D,) draw per call: vmap it over the rows
    y_ref = jax.vmap(lambda d: jax.scipy.linalg.solve_triangular(jnp.asarray(chol), d, lower=True))(
        jnp.asarray(draw))
    y = tt.sample_prior(None, 8)
    _close(y, y_ref, 1e-6, 1e-6)
    assert jt.prior.chol.shape == (3, 3)


def test_bounded_target_is_minus_inf_outside():
    base = tex.normal_target(2)
    tt = kt.bounded_target(base, lower=-1.0, upper=2.0)
    x = torch.tensor([[0.0, 0.5], [-1.5, 0.0], [0.0, 2.5], [2.0, -1.0]])
    v = tt.logdensity(x)
    assert torch.isneginf(v[1]) and torch.isneginf(v[2])
    _close(v[[0, 3]], base.logdensity(x[[0, 3]]), 0, 0)
    # the autograd default differentiates through the mask
    v2, g2 = tt.logdensity_and_grad(x)
    assert torch.isneginf(v2[1]) and torch.isfinite(g2[0]).all()
    jv = jax.vmap(jkt.bounded_target(jex.normal_target(2), lower=-1.0, upper=2.0).logdensity)(
        jnp.asarray(x.numpy()))
    _close(v, jv, 0, 0)
