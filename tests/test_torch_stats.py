"""The port's stats layer against klara_tpu's on the same fixed traces:
ESS, MCSE and IACT under all four estimators, split-R̂, rank-R̂, bulk and
tail ESS, a bf16 trace (promotion to f32) and a trace with ties and an even
draw count (the median of the folded rank-R̂).  Both sides reduce in f32
with different FFT and summation orders: rtol 1e-4 (ESS sums Geyer
sequences over up to 400 lags)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.jobs.chain import Chain as JChain

import klara_tpu_torch as kt
from klara_tpu_torch import convert
from klara_tpu_torch.stats.rhat import _median0, _quantile0


def _ar1_trace(n=400, m=6, d=3, rho=0.7, seed=0):
    """An AR(1) trace (n, m, d) with distinct per-dimension scales."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, m, d)).astype(np.float32)
    x = np.empty_like(e)
    x[0] = e[0]
    for t in range(1, n):
        x[t] = rho * x[t - 1] + e[t]
    return (x * np.array([1.0, 3.0, 0.2], np.float32)[:d] + 0.5).astype(np.float32)


def _close(a, b, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("estimator", ["iid", "bm", "imse", "ipse"])
def test_estimators_match_jax(estimator):
    x = _ar1_trace()
    xt = torch.from_numpy(x)
    for fn in ("ess", "mcse", "iact", "mcvar"):
        _close(getattr(kt.stats, fn)(xt, estimator), getattr(jkt.stats, fn)(jnp.asarray(x), estimator))
    _close(kt.stats.ess(xt, estimator, combine_chains=False),
           jkt.stats.ess(jnp.asarray(x), estimator, combine_chains=False))


def test_autocov_matches_jax():
    x = _ar1_trace(n=101)
    _close(kt.stats.autocov(torch.from_numpy(x), 20), jkt.stats.autocov(jnp.asarray(x), 20), 1e-4, 1e-5)


def test_rhat_family_matches_jax():
    x = _ar1_trace(n=301, seed=1)
    x[:, 0] += 0.3  # one chain off: R̂ visibly above 1
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for fn in ("rhat", "rhat_rank", "ess_bulk", "ess_tail"):
        _close(getattr(kt.stats, fn)(xt), getattr(jkt.stats, fn)(xj))
    assert float(kt.stats.rhat(xt).max()) > 1.01


def test_chain_objects_and_acceptance_match_jax():
    x = _ar1_trace(n=50, seed=2)
    acc = (np.random.default_rng(3).random((50, 6)) < 0.7)
    jc = JChain(samples={"value": jnp.asarray(x)}, diagnostics={"accept": jnp.asarray(acc)},
                final_state=None)
    tc = convert.chain_from_numpy({"value": x}, {"accept": acc}, device="cpu")
    _close(kt.stats.acceptance(tc), jkt.stats.acceptance(jc), 1e-6)
    _close(kt.stats.acceptance(tc, per_chain=True), jkt.stats.acceptance(jc, per_chain=True), 1e-6)
    _close(kt.stats.mean(tc), jkt.stats.mean(jc), 1e-6)
    _close(kt.stats.mean(tc, per_chain=True), jkt.stats.mean(jc, per_chain=True), 1e-6)
    _close(kt.stats.ess(tc), jkt.stats.ess(jc))
    assert tc.flat().shape == (300, 3) and tc.n_post == 50 and tc.n_chains == 6


def test_bf16_trace_is_promoted_like_jax():
    """A bf16 trace reduces in f32 in both packages (the stored values are
    the same bf16 numbers)."""
    x = _ar1_trace(n=200, seed=4)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xt.to(torch.float32).numpy()).astype(jnp.bfloat16)
    for fn in ("ess", "rhat_rank", "mean"):
        out = getattr(kt.stats, fn)(xt)
        assert out.dtype == torch.float32
        _close(out, getattr(jkt.stats, fn)(xj))
    assert jkt.stats.mean(xj).dtype == jnp.float32


def test_ties_and_even_count_median_match_jax():
    """Rounded draws give ties; an even number of values makes the median
    the mean of the two middle ones (torch.median would take the lower)."""
    x = np.round(_ar1_trace(n=200, m=4, seed=5) * 2.0) / 2.0
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    flat = x.reshape(-1, x.shape[-1])
    np.testing.assert_array_equal(_median0(torch.from_numpy(flat)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(flat), axis=0)))
    four = np.array([[4.0, 1.0], [1.0, 1.0], [3.0, 2.0], [2.0, 2.0]], np.float32)
    np.testing.assert_array_equal(_median0(torch.from_numpy(four)).numpy(), [2.5, 1.5])
    np.testing.assert_array_equal(np.asarray(jnp.median(jnp.asarray(four), axis=0)), [2.5, 1.5])
    for q in (0.05, 0.5, 0.95):
        _close(_quantile0(torch.from_numpy(flat), q), jnp.quantile(jnp.asarray(flat), q, axis=0), 1e-6)
    for fn in ("rhat_rank", "ess_bulk", "ess_tail"):
        _close(getattr(kt.stats, fn)(xt), getattr(jkt.stats, fn)(xj))
