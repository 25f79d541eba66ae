"""The Gibbs slice as a whole: bench.py's rats Gibbs row (the conjugate
rats model, five monitored hyperparameters) in both packages at 64 chains
x 2000 sweeps (500 burnin), compared in distribution: the posterior means
agree within 4x the combined Monte Carlo standard error (per-chain Geyer
IMSE variances of the chain means), and rank-R-hat is under 1.05 in both.
Both runs are scored by the port's statistics (tests/test_torch_stats.py
holds them to JAX's)."""

import numpy as np
import jax
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch.models import examples as tex

C, SWEEPS, BURNIN = 64, 2000, 500
MONITOR = ("alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")


@pytest.fixture(scope="module")
def runs():
    model, v0 = jex.rats_gibbs_model()
    jchains = jkt.GibbsJob(model, {}, jkt.MCRange(n_steps=SWEEPS, burnin=BURNIN), n_chains=C,
                           monitor=MONITOR).run(jax.random.key(0), v0)
    model, v0 = tex.rats_gibbs_model(device="cpu")
    tchains = kt.GibbsJob(model, {}, kt.MCRange(n_steps=SWEEPS, burnin=BURNIN), n_chains=C,
                          monitor=MONITOR).run(torch.Generator().manual_seed(0), v0)
    return jchains, tchains


def _trace(chains, key):
    return torch.from_numpy(np.array(chains.samples[key]))


def _mean_and_se(x):
    return float(kt.stats.mean(x)), float(np.sqrt(kt.stats.mcvar(x).numpy().mean(0) / x.shape[1]))


@pytest.mark.parametrize("key", MONITOR)
def test_rats_posterior_means_agree_within_mcse(runs, key):
    jchains, tchains = runs
    assert tchains.samples[key].shape == (SWEEPS - BURNIN, C)
    assert torch.isfinite(tchains.samples[key]).all()
    mj, sej = _mean_and_se(_trace(jchains, key))
    mt, set_ = _mean_and_se(tchains.samples[key])
    assert abs(mj - mt) < 4.0 * np.sqrt(sej**2 + set_**2), (key, mj, mt, sej, set_)


def test_rats_rhat_in_both_and_the_bugs_posterior(runs):
    jchains, tchains = runs
    for key in MONITOR:
        for x in (_trace(jchains, key), tchains.samples[key]):
            assert float(kt.stats.rhat_rank(x).max()) < 1.05
    # the published BUGS posterior means of the rats example
    assert abs(float(tchains.samples["alpha_c"].double().mean()) - 242.5) < 1.0
    assert abs(float(tchains.samples["beta_c"].double().mean()) - 6.19) < 0.1
    assert set(tchains.final_values) == {"alpha", "beta", *MONITOR}
    assert tchains.final_values["alpha"].shape == (C, 30)
