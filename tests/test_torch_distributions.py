"""The port's distributions against klara_tpu's, class by class, on the same
seeded numpy inputs: logpdf (out-of-support points included, -inf there in
both) and mean at rtol 1e-5 (logpdf with atol 5e-6: a value near 0 is a
difference of f32 log-gamma terms up to ~10, whose ulp is ~1e-6); draws in
distribution (two-sample KS test against JAX's draws at 20k each, p > 1e-4, and sample means within 6
standard errors); the default sample shape with a (C,) parameter; the
integer dtypes; and the per-chain draw a Gibbs job makes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

from klara_tpu import distributions as jd

from klara_tpu_torch import distributions as td

C, D, N_DRAWS = 6, 3, 20000
RTOL = 1e-5


def _rng():
    return np.random.default_rng(5)


def _spd(rng, d):
    a = rng.standard_normal((d, d)).astype(np.float32)
    return (a @ a.T + d * np.eye(d)).astype(np.float32)


def _f32(*arrays):
    return tuple(np.asarray(a, np.float32) for a in arrays)


def _case(name):
    """(args for the class, x points, scalar args for sampling, a (C,)-param
    args for the shape test).  Arrays are numpy; both packages get copies."""
    rng = _rng()
    u = lambda lo, hi, n=C: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    if name == "Normal":
        return _f32(u(-2, 2), u(0.5, 2)), u(-4, 4), (0.5, 2.0), (u(-1, 1), 1.0)
    if name == "LogNormal":
        x = np.concatenate([u(0.1, 5, C - 2), [-1.0, 0.0]]).astype(np.float32)
        return _f32(u(-1, 1), u(0.3, 1)), x, (0.2, 0.5), (u(-1, 1), 0.5)
    if name == "Uniform":
        return _f32(u(-2, -1), u(1, 2)), u(-3, 3), (-1.0, 2.5), (u(-2, -1), 1.0)
    if name == "Exponential":
        return _f32(u(0.5, 3)), u(-1, 3), (1.7,), (u(0.5, 3),)
    if name == "Laplace":
        return _f32(u(-1, 1), u(0.5, 2)), u(-4, 4), (0.3, 1.5), (u(-1, 1), 1.0)
    if name == "Gamma":
        x = np.concatenate([u(0.1, 5, C - 2), [-1.0, 0.0]]).astype(np.float32)
        return _f32(u(0.5, 4), u(0.5, 2)), x, (2.5, 1.5), (u(0.5, 4), 1.0)
    if name == "InverseGamma":
        x = np.concatenate([u(0.1, 5, C - 2), [-1.0, 0.0]]).astype(np.float32)
        return _f32(u(2.5, 5), u(0.5, 2)), x, (3.5, 2.0), (3.0, u(0.5, 2))
    if name == "Beta":
        return _f32(u(0.5, 4), u(0.5, 4)), u(-0.2, 1.2), (2.0, 3.5), (u(0.5, 4), 2.0)
    if name == "TruncatedNormal":
        x = u(-3, 3)
        return (_f32(u(-1, 1), u(0.5, 2), np.full(C, -1.5), np.full(C, 2.0)), x,
                (0.5, 1.2, -1.0, 2.5), (u(-1, 1), 1.0, -2.0, 2.0))
    if name == "MvNormal":
        loc = rng.standard_normal(D).astype(np.float32)
        chol = np.linalg.cholesky(_spd(rng, D)).astype(np.float32)
        x = rng.standard_normal((C, D)).astype(np.float32)
        return (loc, chol), x, (loc, chol), (rng.standard_normal((C, D)).astype(np.float32), chol)
    if name == "Dirichlet":
        alpha = u(0.5, 3, D)
        x = rng.dirichlet(np.ones(D), C).astype(np.float32)
        x[0] = [0.5, 0.6, -0.1]  # off the simplex
        return (alpha,), x, (alpha,), (np.tile(alpha, (C, 1)),)
    if name == "Bernoulli":
        return _f32(u(0.1, 0.9)), np.array([0, 1, 1, 0, 2, 1], np.int32), (0.3,), (u(0.1, 0.9),)
    if name == "Binary":
        return ((-1, 2, u(0.1, 0.9)), np.array([-1, 2, 0, 2, -1, 5], np.int32), (-1, 2, 0.3),
                (-1, 2, u(0.1, 0.9)))
    if name == "Binomial":
        return ((10, u(0.1, 0.9)), np.array([-1, 0, 3, 10, 11, 7], np.int32), (10, 0.35),
                (10, u(0.1, 0.9)))
    if name == "Poisson":
        return _f32(u(0.5, 6)), np.array([-1, 0, 1, 4, 9, 2], np.int32), (3.5,), (u(0.5, 6),)
    raise KeyError(name)


NAMES = [
    "Normal", "LogNormal", "Uniform", "Exponential", "Laplace", "Gamma",
    "InverseGamma", "Beta", "TruncatedNormal", "MvNormal", "Dirichlet",
    "Bernoulli", "Binary", "Binomial", "Poisson",
]
# one draw spans the last axis: JAX evaluates these per vector
VECTOR = {"MvNormal", "Dirichlet"}


def _both(name, args):
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    return getattr(jd, name)(*jargs), getattr(td, name)(*targs)


def test_the_fifteen_classes_are_all_ported():
    assert sorted(NAMES) == sorted(
        n for n in jd.__all__ if n not in ("Distribution", "lognormalise_truncated_normal")
    )


@pytest.mark.parametrize("name", NAMES)
def test_logpdf_and_mean_match_jax(name):
    args, x, _, _ = _case(name)
    jdist, tdist = _both(name, args)
    if name in VECTOR:
        ref = jax.vmap(jdist.logpdf)(jnp.asarray(x))
    else:
        ref = jdist.logpdf(jnp.asarray(x))
    out = tdist.logpdf(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=5e-6)
    np.testing.assert_allclose(np.asarray(tdist.mean()), np.asarray(jdist.mean()), rtol=RTOL)
    if name == "Normal":
        np.testing.assert_allclose(tdist.var().numpy(), np.asarray(jdist.var()), rtol=RTOL)


def test_lognormalise_truncated_normal_matches_jax():
    rng = _rng()
    loc, scale = rng.uniform(-2, 2, 8).astype(np.float32), rng.uniform(0.3, 3, 8).astype(np.float32)
    low, high = np.float32(-1.0), np.float32(0.5)
    ref = jd.lognormalise_truncated_normal(jnp.asarray(loc), jnp.asarray(scale), low, high)
    out = td.lognormalise_truncated_normal(torch.tensor(loc), torch.tensor(scale), float(low),
                                           float(high))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL)


def test_binary_succprob_failprob_pdf():
    _, tdist = _both("Binary", (-1, 2, 0.3))
    assert tdist.succprob() == 0.3 and abs(tdist.failprob() - 0.7) < 1e-12
    pdf = tdist.pdf(torch.tensor([-1, 2, 0]))
    np.testing.assert_allclose(pdf.numpy(), [0.7, 0.3, 0.0], rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_draws_match_jax_in_distribution(name):
    _, _, args, _ = _case(name)
    jdist, tdist = _both(name, args)
    jx = np.asarray(jdist.sample(jax.random.key(0), (N_DRAWS,)), np.float64)
    tx = tdist.sample(torch.Generator().manual_seed(0), (N_DRAWS,)).double().numpy()
    assert tx.shape == jx.shape
    jx, tx = jx.reshape(N_DRAWS, -1), tx.reshape(N_DRAWS, -1)
    for j in range(jx.shape[1]):
        p = scipy.stats.ks_2samp(jx[:, j], tx[:, j]).pvalue
        assert p > 1e-4, (name, j, p)
    se = np.sqrt((jx.var(0) + tx.var(0)) / N_DRAWS)
    assert np.all(np.abs(jx.mean(0) - tx.mean(0)) <= 6 * se + 1e-12), (jx.mean(0), tx.mean(0))


def test_truncated_normal_far_tail_stays_in_support():
    # an interval where Φ loses all its float32 digits, and one past float64's
    d = td.TruncatedNormal(0.0, 1.0, 9.0, 12.0)
    x = d.sample(torch.Generator().manual_seed(1), (4000,))
    assert torch.all((x >= 9.0) & (x <= 12.0))
    assert abs(float(x.mean()) - 9.1) < 0.05  # E ≈ a + 1/a in the far tail
    x = td.TruncatedNormal(0.0, 1.0, 45.0).sample(torch.Generator().manual_seed(1), (10,))
    assert torch.all(torch.isfinite(x) & (x >= 45.0))


# the classes whose sample takes a replayed standard draw: that draw's
# sampler, and the drawn value's CDF as a function of the draw's CDF (the
# transform is monotone; InverseGamma's decreasing).  Parameters are the
# scalar sampling args of _case.
_REPLAY = {
    "Normal": ("normal", scipy.stats.norm(0.5, 2.0), scipy.stats.norm.cdf),
    "LogNormal": ("normal", scipy.stats.lognorm(0.5, scale=np.exp(0.2)), scipy.stats.norm.cdf),
    "Uniform": ("uniform", scipy.stats.uniform(-1.0, 3.5), lambda s: s),
    "Exponential": ("exponential", scipy.stats.expon(scale=1 / 1.7), scipy.stats.expon.cdf),
    "Laplace": ("laplace", scipy.stats.laplace(0.3, 1.5), scipy.stats.laplace.cdf),
    "Gamma": ("gamma", scipy.stats.gamma(2.5, scale=1 / 1.5), scipy.stats.gamma(2.5).cdf),
    "InverseGamma": ("gamma", scipy.stats.invgamma(3.5, scale=2.0),
                     lambda s: 1.0 - scipy.stats.gamma(3.5).cdf(s)),
    "TruncatedNormal": ("uniform", scipy.stats.truncnorm(-1.5 / 1.2, 2.0 / 1.2, 0.5, 1.2),
                        lambda s: s),
}


@pytest.mark.parametrize("name", sorted(_REPLAY) + ["MvNormal"])
def test_sample_replays_its_standard_draw(name):
    """``sample(noise=)`` transforms the given standard draw (the Gibbs and
    MH parity tests feed JAX's draws this way): F_X(x) = F_draw(draw),
    atol 2e-6 for the f32 draws."""
    _, _, args, _ = _case(name)
    _, tdist = _both(name, args)
    rng = _rng()
    if name == "MvNormal":
        z = rng.standard_normal((50, D)).astype(np.float32)
        x = tdist.sample(torch.Generator(), (50,), noise=torch.tensor(z)).numpy()
        np.testing.assert_allclose(x, args[0] + z @ args[1].T, rtol=1e-5, atol=1e-5)
        return
    base, dist, base_cdf = _REPLAY[name]
    s = {"normal": lambda: rng.standard_normal(200),
         "uniform": lambda: rng.uniform(1e-6, 1 - 1e-6, 200),
         "exponential": lambda: rng.standard_exponential(200),
         "laplace": lambda: rng.laplace(size=200),
         "gamma": lambda: rng.standard_gamma(args[0], 200)}[base]().astype(np.float32)
    x = tdist.sample(torch.Generator(), (200,), noise=torch.tensor(s))
    assert x.dtype == torch.float32 and x.shape == (200,)
    np.testing.assert_allclose(dist.cdf(x.double().numpy()), base_cdf(s.astype(np.float64)),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", NAMES)
def test_default_sample_shape_with_a_per_chain_parameter(name):
    _, _, _, args = _case(name)
    jdist, tdist = _both(name, args)
    if name in VECTOR:
        jshape = (C, D)  # JAX samples these per vector, under vmap
    else:
        jshape = jax.eval_shape(jdist.sample, jax.random.key(0)).shape
    assert tuple(tdist.sample(torch.Generator().manual_seed(0)).shape) == tuple(jshape) == (
        (C, D) if name in VECTOR else (C,))


@pytest.mark.parametrize("name", ["Bernoulli", "Binary", "Binomial", "Poisson"])
def test_integer_draws_are_int32_as_in_jax(name):
    _, _, args, _ = _case(name)
    jdist, tdist = _both(name, args)
    jdt = np.asarray(jdist.sample(jax.random.key(0), (4,))).dtype
    assert jdt == np.int32
    assert tdist.sample(torch.Generator().manual_seed(0), (4,)).dtype == torch.int32


def test_draw_per_chain_keeps_the_shared_gamma_draw_of_jax():
    """A Gamma with a scalar shape and a vector rate: JAX draws one gamma per
    chain (its shape comes from the shape parameter alone) and divides the
    vector by it; the port's per-chain draw does the same, independently
    across chains."""
    rate = np.array([1.0, 2.0, 4.0], np.float32)
    per_chain = jax.vmap(lambda k: jd.Gamma(3.0, jnp.asarray(rate)).sample(k))(
        jax.random.split(jax.random.key(0), C))
    g = np.asarray(per_chain) * rate
    np.testing.assert_allclose(g, np.repeat(g[:, :1], 3, 1), rtol=1e-6)

    like = torch.zeros(C, 3)
    draw = td.draw_per_chain(td.Gamma(3.0, torch.tensor(rate)), like,
                             torch.Generator().manual_seed(0))
    g = (draw * torch.tensor(rate)).numpy()
    np.testing.assert_allclose(g, np.repeat(g[:, :1], 3, 1), rtol=1e-6)
    assert len(np.unique(g[:, 0])) == C
    # all-constant parameters still give one independent draw per chain
    z = td.draw_per_chain(td.Normal(0.0, 1.0), torch.zeros(C, 1, dtype=torch.float64),
                          torch.Generator().manual_seed(0))
    assert z.shape == (C, 1) and z.dtype == torch.float64 and len(np.unique(z.numpy())) == C
