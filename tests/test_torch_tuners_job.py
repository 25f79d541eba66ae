"""The port's tuners, job adaptation hooks and preconditioner algebra against
klara_tpu on identical inputs: the dual-averaging update sequence, one JAX
scan step's pooled-tuning + mass + ChEES hooks fed with that step's
pre-step states and infos, the pooled initial step, and the ensemble
covariance / shrinkage / Cholesky of run_preconditioned.  f32 throughout."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch import convert
from klara_tpu_torch.jobs.job import ensemble_cholesky
from klara_tpu_torch.samplers.base import Info

C, D, N, BURNIN = 64, 4, 150, 20


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("tuner_cls", ["DualAveragingTuner", "VanillaTuner"])
def test_tuner_update_sequence_matches_jax(tuner_cls):
    """150 updates (past nadapt=100 and a period boundary) of 6 chains from
    the same accept / accept_stat sequence, then finalize.  Same f32
    formulas; exp/log/pow may differ in the last ulp, compounded over the
    sequence: rtol 1e-5."""
    kw = dict(targetrate=0.7, nadapt=100) if tuner_cls == "DualAveragingTuner" else {}
    jt = getattr(jkt, tuner_cls)(period=40, **kw)
    tt = getattr(kt, tuner_cls)(period=40, **kw)
    rng = np.random.default_rng(0)
    step0 = rng.uniform(0.05, 0.5, 6).astype(np.float32)
    js = jax.vmap(jt.init)(jnp.asarray(step0))
    ts = tt.init(torch.from_numpy(step0))
    if tuner_cls == "DualAveragingTuner":
        js = jax.vmap(jt.set_mu_from_step)(js)
        ts = tt.set_mu_from_step(ts)
    upd = jax.jit(jax.vmap(lambda s, a, st: jt.update(s, a, st, 120)))
    for k in range(150):
        acc = (rng.random(6) < 0.6).astype(np.float32)
        stat = rng.random(6).astype(np.float32)
        js = upd(js, jnp.asarray(acc), jnp.asarray(stat))
        ts = tt.update(ts, torch.from_numpy(acc), torch.from_numpy(stat), 120)
        for a, b in zip(jax.tree.leaves(_np(js)), jax.tree.leaves(tuple(ts))):
            _close(b, a, 1e-5, 1e-6)
    _close(tt.finalize(ts).step, jax.vmap(jt.finalize)(js).step, 1e-5, 1e-6)


def _jobs():
    """The same pooled HMC + mass + ChEES job in both packages."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((C, D))).astype(np.float32)
    kw = dict(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
              jitter_style="step", max_nleaps=256)
    common = dict(n_chains=C, monitor=("value",), diagnostics=("accept", "nleaps"),
                  pooled_tuning=True, mass_adaptation=True, mass_period=5,
                  traj_adaptation=True)
    jjob = jkt.MCJob(jex.logistic_regression_target(X, y, 10.0), jkt.HMC(**kw),
                     jkt.MCRange(n_steps=BURNIN + 10, burnin=BURNIN),
                     tuner=jkt.DualAveragingTuner(0.8, BURNIN), **common)
    tjob = kt.MCJob(convert.target_arrays(X, y, 10.0, device="cpu"), kt.HMC(**kw),
                    kt.MCRange(n_steps=BURNIN + 10, burnin=BURNIN),
                    tuner=kt.DualAveragingTuner(0.8, BURNIN), **common)
    return jjob, tjob, x0


def test_pooled_initial_step_matches_jax():
    """Per-chain Alg-4 searches from JAX's momentum draws, pooled to one
    geometric-mean step with μ re-anchored."""
    jjob, tjob, x0 = _jobs()
    key = jax.random.key(1)
    states = jjob._init_states(key, jnp.asarray(x0))
    p0 = jax.vmap(lambda k: jax.random.normal(k, (D,), jnp.float32))(jax.random.split(key, C))
    tstates = tjob._init_states(None, torch.from_numpy(x0), momentum=torch.tensor(np.asarray(p0)))
    _close(tstates.tune.step, states.tune.step, 1e-6, 0)
    _close(tstates.tune.extra.mu, states.tune.extra.mu, 1e-6, 1e-6)
    assert float(np.ptp(np.asarray(states.tune.step))) == 0.0


@pytest.mark.parametrize("i", [3, 4])
def test_adaptation_hooks_match_one_jax_scan_step(i):
    """Run JAX's scan body for steps 0..i-1, then replay step i's kernel
    call (shared jitter draw and all) to get its infos; the port's hooks,
    fed JAX's pre-step positions, post-kernel states and infos, must give
    JAX's post-step states.  At i=4 the mass update fires (period 5);
    ChEES is active from step 2."""
    jjob, tjob, x0 = _jobs()
    init_key, run_key = jax.random.split(jax.random.key(2))
    states = jjob._init_states(init_key, jnp.asarray(x0))
    chain_keys = jax.random.split(run_key, C)
    body = jjob._scan_fn(chain_keys, save=False)
    for k in range(i):
        (states, _), _ = body((states, ({}, {})), jnp.int32(k))
    (post, _), _ = body((states, ({}, {})), jnp.int32(i))

    sampler = jjob.sampler
    jit_key = jax.random.fold_in(jax.random.fold_in(chain_keys[0], 2**31 - 1), i)
    frac = jax.random.uniform(jit_key, minval=1.0 - sampler.jitter,
                              maxval=1.0 + sampler.jitter, dtype=jnp.float32)
    step_sampler = dataclasses.replace(sampler, jitter=0.0)
    jittered = states._replace(log_traj=states.log_traj + jnp.log(frac))
    mid, infos = jax.vmap(
        lambda k, s: step_sampler.step(jax.random.fold_in(k, i), s, jjob.target)
    )(chain_keys, jittered)
    mid = mid._replace(log_traj=states.log_traj)
    np.testing.assert_array_equal(np.asarray(mid.position), np.asarray(post.position))

    tinfo = Info(*(torch.tensor(np.asarray(a)) for a in infos[:3]),
                 extras={k: torch.tensor(np.asarray(v)) for k, v in infos.extras.items()})
    out = tjob.adapt(torch.tensor(np.asarray(states.position)),
                     convert.hmc_state_from_numpy(_np(mid), device="cpu"), tinfo, i,
                     torch.tensor(np.asarray(frac)))
    ref = convert.hmc_state_from_numpy(_np(post), device="cpu")
    # the ChEES gradient is a mean of products of chain-mean-centred
    # sums: f32 reduction order gives ~1e-6 relative noise in log λ, Adam
    # moments, and the ensemble variance
    for name in ("inv_mass", "log_traj", "traj_m", "traj_v"):
        _close(getattr(out, name), getattr(ref, name), 2e-5, 1e-7)
    for a, b in zip(out.tune, ref.tune):
        for u, w in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            _close(u, w, 1e-5, 1e-7)
    if i == 4:
        assert not np.allclose(np.asarray(ref.inv_mass), 1.0)
    assert float(np.abs(np.asarray(ref.traj_m)).max()) > 0


def test_ensemble_cholesky_matches_run_preconditioned_formulas():
    """Covariance (/(n−1)), shrinkage toward the diagonal with weight
    n/(n+D), relative ridge and Cholesky, as run_preconditioned computes
    them, plus the whitened start y0 = L⁻¹x."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((D, D)).astype(np.float32)
    x_end = (rng.standard_normal((C, D)) @ A + 1.0).astype(np.float32)

    xj = jnp.asarray(x_end)
    xc = xj - jnp.mean(xj, axis=0, keepdims=True)
    cov = (xc.T @ xc) / (C - 1)
    w = C / (C + D)
    cov = w * cov + (1.0 - w) * jnp.diag(jnp.diag(cov))
    lam = 1e-6 * jnp.mean(jnp.diag(cov)) + 1e-12
    chol_ref = jnp.linalg.cholesky(cov + lam * jnp.eye(D, dtype=cov.dtype))
    y0_ref = jax.scipy.linalg.solve_triangular(chol_ref, xj.T, lower=True).T

    chol = ensemble_cholesky(torch.from_numpy(x_end))
    y0 = torch.linalg.solve_triangular(chol, torch.from_numpy(x_end).T, upper=False).T
    _close(chol, chol_ref, 1e-5, 1e-6)
    _close(y0, y0_ref, 1e-5, 1e-5)
    # a bf16 trace's last draw is factored in f32
    assert ensemble_cholesky(torch.from_numpy(x_end).to(torch.bfloat16)).dtype == torch.float32


def test_mcrange_matches_jax():
    for n_steps, burnin, thinning in [(10, 0, 1), (700, 300, 1), (2700, 300, 2), (11, 3, 4)]:
        assert (kt.MCRange(n_steps, burnin, thinning).n_post
                == jkt.MCRange(n_steps, burnin, thinning).n_post)
    with pytest.raises(ValueError):
        kt.MCRange(5, 5)
