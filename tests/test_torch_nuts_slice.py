"""The NUTS slice as a whole: ``MCJob.run_preconditioned`` with the
``nuts_precond`` settings of bench.py (stage 1 the chees_precond ChEES HMC
warmup, stage 2 whitened NUTS(max_doublings=3) with its own diagnostics) in
both packages at a small size, compared in distribution (the two packages'
random streams differ); plus the port's counterparts of the JAX package's
phased-run and NUTS-stage-2 tests."""

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
    repl = dict(sampler=pkg.NUTS(max_doublings=3), traj_adaptation=False,
                diagnostics=("accept", "na"))
    kw = dict(mcrange=pkg.MCRange(n_steps=BURNIN + POST, burnin=BURNIN),
              tuner=pkg.DualAveragingTuner(0.8, BURNIN), n_chains=C,
              monitor=("value",), diagnostics=("accept", "nleaps"),
              pooled_tuning=True, mass_adaptation=True, mass_period=50,
              traj_adaptation=True)
    return s1, repl, kw


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


def test_nuts_precond_posterior_means_agree_within_mcse(runs):
    jchain, (tchain, _) = runs
    assert tchain.value.shape == (POST, C, D)
    assert torch.isfinite(tchain.value).all()
    mj, sej = _grand_mean_and_se(jkt.stats, jnp.asarray(jchain.value))
    mt, set_ = _grand_mean_and_se(kt.stats, tchain.value)
    # 4x the combined standard error of the two independent estimates
    assert np.all(np.abs(mj - mt) < 4.0 * np.sqrt(sej**2 + set_**2)), (mj, mt, sej, set_)


def test_nuts_precond_rhat_and_tree_sizes_in_both(runs):
    jchain, (tchain, _) = runs
    assert float(jnp.max(jkt.stats.rhat_rank(jchain))) < 1.05
    assert float(kt.stats.rhat_rank(tchain).max()) < 1.05
    na_j = float(jnp.mean(jchain["na"]))
    na_t = float(tchain["na"].double().mean())
    assert 1.0 <= na_t <= 7.0 and abs(na_t - na_j) < 0.1 * na_j, (na_t, na_j)
    assert tchain["accept"].dtype == torch.bool


def test_nuts_precond_same_generator_seed_reproduces_the_trace(runs):
    _, (a, b) = runs
    assert torch.equal(a.value, b.value)
    assert torch.equal(a["na"], b["na"])


def test_nuts_precond_cpu_path_launches_no_kernel(runs, launches):
    assert launches == [0]


def _std_normal(dim):
    return kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=dim)


def test_run_phased_nuts():
    """run_phased gives run's draws: every adaptation is frozen by the end
    of burnin (dual averaging stops at nadapt=80 < burnin=100)."""
    def job():
        return kt.MCJob(_std_normal(2), kt.NUTS(max_doublings=4),
                        kt.MCRange(n_steps=300, burnin=100),
                        tuner=kt.DualAveragingTuner(0.8, 80), n_chains=8,
                        pooled_tuning=True)

    x0 = 0.1 * torch.randn(8, 2, generator=torch.Generator().manual_seed(9))
    phased, timings = job().run_phased(torch.Generator().manual_seed(2), x0)
    ref = job().run(torch.Generator().manual_seed(2), x0)
    assert torch.equal(ref.value, phased.value)
    assert set(timings) == {"warmup_seconds", "sampling_seconds"}


def test_run_preconditioned_nuts_stage2():
    """stage2_replace swaps the whitened stage to NUTS with its own
    diagnostics (stage 1 is HMC and has no 'na' channel), and the ensemble
    mass reaches NUTSState.inv_mass during the stage-2 warmup."""
    rho = 0.9
    cov = np.array([[1.0, rho], [rho, 1.0]], np.float32)
    prec = torch.tensor(np.linalg.inv(cov))
    target = kt.Target(logdensity_fn=lambda x: -0.5 * ((x @ prec) * x).sum(-1), dim=2)
    job = kt.MCJob(
        target,
        kt.HMC(leapstep=0.1, nleaps=4, trajectory_length=0.5,
               jitter=0.9, jitter_style="step", max_nleaps=64),
        kt.MCRange(n_steps=1200, burnin=500),
        tuner=kt.DualAveragingTuner(0.8, 500),
        n_chains=64,
        monitor=("value",),
        diagnostics=("accept", "nleaps"),
        pooled_tuning=True,
        mass_adaptation=True,
        traj_adaptation=True,
    )
    chain, timings, info = job.run_preconditioned(
        torch.Generator().manual_seed(2), torch.zeros(64, 2),
        stage2_replace=dict(sampler=kt.NUTS(max_doublings=3), traj_adaptation=False,
                            diagnostics=("accept", "na")),
    )
    flat = chain.flat("value").numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.12)
    assert float(chain["na"].double().mean()) >= 1.0
    assert isinstance(chain.final_state, kt.NUTSState)
    assert not torch.allclose(chain.final_state.inv_mass, torch.ones(()))
