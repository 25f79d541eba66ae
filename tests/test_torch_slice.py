"""The main path as a whole: ``MCJob.run_preconditioned`` with the
``chees_precond`` settings of bench.py (HMC with shared jitter 0.9, ChEES
stage 1, pooled dual averaging at 0.8, ensemble mass every 50 steps, stage 2
whitened with λ pinned at 2.0) in both packages, at a small size.  The two
packages' random streams differ, so they are compared in distribution."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch.models import examples as tex
from klara_tpu_torch.utils import tracing

D, N, C, BURNIN, POST = 5, 100, 256, 200, 200


def _settings(pkg):
    s1 = pkg.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                 jitter_style="step", max_nleaps=256)
    s2 = pkg.HMC(leapstep=0.05, nleaps=8, trajectory_length=2.0, jitter=0.9,
                 jitter_style="step", max_nleaps=64)
    kw = dict(mcrange=pkg.MCRange(n_steps=BURNIN + POST, burnin=BURNIN),
              tuner=pkg.DualAveragingTuner(0.8, BURNIN), n_chains=C,
              monitor=("value",), diagnostics=("accept", "nleaps"),
              pooled_tuning=True, mass_adaptation=True, mass_period=50,
              traj_adaptation=True)
    return s1, dict(sampler=s2, traj_adaptation=False), kw


def _k1_launches():
    """The tracer's count of K1 launches."""
    return tracing.counters().get("ops.logreg.KERNEL_LAUNCHES", (0, 0))[0]


@pytest.fixture(scope="module")
def launches():
    """The K1 launches of the module's port runs (appended by ``runs``)."""
    return []


@pytest.fixture(scope="module")
def runs(launches):
    x0 = (0.1 * np.random.default_rng(42).standard_normal((C, D))).astype(np.float32)

    jt, _, _ = jex.synthetic_logistic_regression(dim=D, n_data=N)
    s1, repl, kw = _settings(jkt)
    jchain, _, _ = jkt.MCJob(jt, s1, **kw).run_preconditioned(
        jax.random.key(0), jnp.asarray(x0), stage2_replace=repl)

    tt, _, _ = tex.synthetic_logistic_regression(dim=D, n_data=N, device="cpu")
    s1, repl, kw = _settings(kt)
    tjob = kt.MCJob(tt, s1, **kw)
    before = _k1_launches()
    tchains = [
        tjob.run_preconditioned(torch.Generator().manual_seed(7), torch.from_numpy(x0),
                                stage2_replace=repl)[0]
        for _ in range(2)
    ]
    launches.append(_k1_launches() - before)
    return jchain, tchains


def _grand_mean_and_se(stats, x):
    """Mean over draws and chains, and its MCSE: per-chain Geyer IMSE
    variances of the chain means, averaged and divided by the chain count."""
    m = x.shape[1]
    return np.asarray(stats.mean(x)), np.sqrt(np.asarray(stats.mcvar(x).mean(0)) / m)


def test_posterior_means_agree_within_mcse(runs):
    jchain, (tchain, _) = runs
    assert tchain.value.shape == (POST, C, D)
    assert torch.isfinite(tchain.value).all()
    mj, sej = _grand_mean_and_se(jkt.stats, jnp.asarray(jchain.value))
    mt, set_ = _grand_mean_and_se(kt.stats, tchain.value)
    # 4x the combined standard error of the two independent estimates
    assert np.all(np.abs(mj - mt) < 4.0 * np.sqrt(sej**2 + set_**2)), (mj, mt, sej, set_)


def test_acceptance_and_rank_rhat_in_both(runs):
    jchain, (tchain, _) = runs
    for acc in (float(jkt.stats.acceptance(jchain)), float(kt.stats.acceptance(tchain))):
        assert abs(acc - 0.8) < 0.1, acc
    assert float(jnp.max(jkt.stats.rhat_rank(jchain))) < 1.05
    assert float(kt.stats.rhat_rank(tchain).max()) < 1.05
    assert int(tchain["nleaps"].min()) >= 1


def test_same_generator_seed_reproduces_the_trace(runs):
    _, (a, b) = runs
    assert torch.equal(a.value, b.value)
    assert torch.equal(a["accept"], b["accept"])


def test_cpu_path_launches_no_kernel(runs, launches):
    assert launches == [0]
