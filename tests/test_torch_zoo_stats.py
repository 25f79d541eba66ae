"""The port's small statistics against klara_tpu's on the same numpy inputs
(f32, rtol 1e-5 unless stated): ``recursive_covariance`` (batched outer
products against the vmapped per-chain form), ``softabs`` (the product
Q f(Λ) Qᵀ, never Q, whose columns' signs are the library's choice),
``logistic``, the zero-variance estimators ``lzv`` and ``qzv``, and
``RobertsRosenthalTuner``'s update sequence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
import klara_tpu_torch as kt

C, D = 16, 4


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("k", [1, 7])
def test_recursive_covariance_matches_jax(k):
    rng = np.random.default_rng(0)
    cov = rng.standard_normal((C, D, D)).astype(np.float32)
    x, m1, m2 = (rng.standard_normal((C, D)).astype(np.float32) for _ in range(3))
    ref = jax.vmap(lambda c, a, b, d: jkt.stats.recursive_covariance(c, k, a, b, d))(
        *(jnp.asarray(v) for v in (cov, x, m1, m2)))
    out = kt.stats.recursive_covariance(*(torch.tensor(v) for v in (cov,)), k,
                                        *(torch.tensor(v) for v in (x, m1, m2)))
    _close(out, ref)
    # a per-chain k, as AM passes it
    out = kt.stats.recursive_covariance(torch.tensor(cov), torch.full((C,), k), torch.tensor(x),
                                        torch.tensor(m1), torch.tensor(m2))
    _close(out, ref)


def test_recursive_covariance_scalar_form_matches_jax():
    rng = np.random.default_rng(1)
    cov, x, m1, m2 = (rng.standard_normal(C).astype(np.float32) for _ in range(4))
    ref = jax.vmap(lambda c, a, b, d: jkt.stats.recursive_covariance(c, 5, a, b, d))(
        *(jnp.asarray(v) for v in (cov, x, m1, m2)))
    _close(kt.stats.recursive_covariance(torch.tensor(cov), 5, torch.tensor(x), torch.tensor(m1),
                                         torch.tensor(m2)), ref)


def test_recursive_mean_matches_jax():
    rng = np.random.default_rng(2)
    m, x = (rng.standard_normal((C, D)).astype(np.float32) for _ in range(2))
    ref = jkt.stats.recursive_mean(jnp.asarray(m), 9, jnp.asarray(x))
    _close(kt.stats.recursive_mean(torch.tensor(m), 9, torch.tensor(x)), ref, rtol=1e-6)


@pytest.mark.parametrize("a", [1000.0, 3.0])
def test_softabs_matches_jax(a):
    """Indefinite symmetric matrices, one of them with a zero eigenvalue;
    eigenvalues differ by ulps between the libraries and 1/tanh magnifies
    that near 0: rtol 1e-4."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((C, D, D)).astype(np.float32)
    h = 0.5 * (h + h.transpose(0, 2, 1))
    h[0] = np.diag([1.0, 0.0, -2.0, 0.5])
    ref = jax.vmap(lambda m: jkt.stats.softabs(m, a))(jnp.asarray(h))
    out = kt.stats.softabs(torch.tensor(h), a)
    _close(out, ref, rtol=1e-4, atol=1e-5)
    assert bool((torch.linalg.eigvalsh(out) > 0).all())


def test_logistic_matches_jax():
    x = np.linspace(-6, 6, 41).astype(np.float32)
    ref = jkt.stats.logistic(jnp.asarray(x), 2.0, 1.5, 0.3, -0.5)
    _close(kt.stats.logistic(torch.tensor(x), 2.0, 1.5, 0.3, -0.5), ref)
    _close(kt.stats.logistic(torch.tensor(x)), jkt.stats.logistic(jnp.asarray(x)))


def _zv_inputs(n=400, d=3):
    """Draws of a correlated normal and its gradients: the linear control
    variate is exact there."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((d, d))
    prec = (a @ a.T / d + np.eye(d)).astype(np.float32)
    x = (rng.standard_normal((n, d)) @ np.linalg.cholesky(np.linalg.inv(prec)).T).astype(
        np.float32) + 1.0
    return x, (-(x - 1.0) @ prec).astype(np.float32)


@pytest.mark.parametrize("which", ["lzv", "qzv"])
def test_zv_matches_jax(which):
    """The solves run in f32 on covariances of 400 draws: adjusted draws and
    coefficients agree to rtol 1e-3 (lzv 1e-4); the solve's conditioning, not
    the port, sets that."""
    x, g = _zv_inputs()
    ref, aref = getattr(jkt.stats, which)(None, jnp.asarray(x), jnp.asarray(g))
    out, a = getattr(kt.stats, which)(None, torch.tensor(x), torch.tensor(g))
    rtol = 1e-4 if which == "lzv" else 1e-3
    _close(out, ref, rtol=rtol, atol=1e-3)
    _close(a, aref, rtol=rtol, atol=1e-3)
    # the control variate removes nearly all the variance of the mean
    assert float(out.var(0).max()) < 1e-3 * float(torch.tensor(x).var(0).min())


def test_zv_reads_a_chain():
    x, g = _zv_inputs(n=120)
    chain = kt.Chain(samples={"value": torch.tensor(x).reshape(30, 4, 3),
                              "gradlogtarget": torch.tensor(g).reshape(30, 4, 3)}, diagnostics={})
    out, _ = kt.stats.lzv(chain)
    ref, _ = kt.stats.lzv(None, torch.tensor(x), torch.tensor(g))
    _close(out, ref, rtol=0, atol=0)
    with pytest.raises(TypeError):
        kt.stats.lzv(torch.tensor(x))
    # 1-d values are one coordinate
    out1, a1 = kt.stats.lzv(None, torch.tensor(x[:, 0]), torch.tensor(g[:, 0]))
    assert out1.shape == (120, 1) and a1.shape == (1, 1)


def test_roberts_rosenthal_sequence_matches_jax():
    """60 sweeps of 8 chains x 3 coordinates at period 10 (six batches, so δ
    walks 0.01 = min(0.01, batch^-½) throughout and the period boundary is
    crossed six times): counters exact, logσ and rates rtol 1e-6."""
    T, m, d = 60, 8, 3
    acc = (np.random.default_rng(5).random((T, m, d)) < np.array([0.1, 0.44, 0.9])).astype(
        np.float32)
    jtuner = jkt.RobertsRosenthalTuner(0.44, period=10)
    ttuner = kt.RobertsRosenthalTuner(0.44, period=10)
    ls0 = np.log(np.full((m, d), 0.7, np.float32))
    jtune = jax.vmap(jtuner.init_vector)(jnp.asarray(ls0))
    ttune = ttuner.init_vector(torch.tensor(ls0))
    jupdate = jax.jit(jax.vmap(lambda t, a: jtuner.update(t, a, a)))
    for t in range(T):
        jtune = jupdate(jtune, jnp.asarray(acc[t]))
        ttune = ttuner.update(ttune, torch.tensor(acc[t]), torch.tensor(acc[t]))
        for f in ("proposed", "totproposed"):
            np.testing.assert_array_equal(getattr(ttune, f).numpy(), np.asarray(getattr(jtune, f)))
        np.testing.assert_array_equal(ttune.extra.batch.numpy(), np.asarray(jtune.extra.batch))
        _close(ttune.step, jtune.step, rtol=1e-6)
        _close(ttune.accepted, jtune.accepted, rtol=0, atol=0)
    _close(ttune.rate, jtune.rate, rtol=1e-6)
    assert ttune.step.shape == (m, d) and ttune.rate.shape == (m,)
    # the low-rate coordinate narrowed, the high-rate one widened
    assert float(ttune.step[:, 0].max()) < float(ls0[0, 0]) < float(ttune.step[:, 2].min())


def test_roberts_rosenthal_first_boundary_uses_delta_of_batch_one():
    """At the first boundary batch becomes 1 before δ is computed; before it
    δ = min(0.01, 0^-½) = 0.01 is computed and discarded, and nothing
    raises on the integer zero."""
    tuner = kt.RobertsRosenthalTuner(0.44, period=2)
    tune = tuner.init_vector(torch.zeros(2, 3))
    one = torch.ones(2, 3)
    tune = tuner.update(tune, one, one)
    assert torch.equal(tune.step, torch.zeros(2, 3)) and bool(torch.isnan(tune.rate).all())
    tune = tuner.update(tune, one, one)
    torch.testing.assert_close(tune.step, torch.full((2, 3), 0.01))
    assert tune.extra.batch.tolist() == [1, 1] and tune.proposed.tolist() == [0, 0]


def test_roberts_rosenthal_vector_adaptation():
    """Counterpart of the JAX package's tuner test: high acceptance widens,
    zero acceptance narrows."""
    tuner = kt.RobertsRosenthalTuner(0.44, period=10)
    tune = tuner.init_vector(torch.zeros(1, 3))
    acc = torch.tensor([[1.0, 0.0, 1.0]])
    for _ in range(20):
        tune = tuner.update(tune, acc, acc)
    logsig = tune.step[0]
    assert logsig[0] > 0 and logsig[2] > 0 and logsig[1] < 0
