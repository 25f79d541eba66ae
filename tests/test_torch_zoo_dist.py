"""The sampler zoo in distribution, through ``MCJob`` on the CPU: the port's
counterparts of the JAX package's statistical tests of AM, RAM, AMWG, slice,
ARS and SMMALA (tests/test_sampler_zoo.py), of MALA under
AcceptanceRateTuner and of NUTS used directly on 0-d and rank-2 per-chain
positions in both tree forms (tests/test_gradient_samplers.py).  Targets
with known moments; 64 chains; the absolute tolerances are the JAX tests'
(0.1 on means, 0.15 on covariances: 3-4 MCSE at these run lengths)."""

import numpy as np
import pytest
import torch

import klara_tpu_torch as kt

RHO = 0.8
COV = np.array([[1.0, RHO], [RHO, 1.0]], dtype=np.float32)
PREC = torch.tensor(np.linalg.inv(COV).astype(np.float32))
C = 64


def corr_target():
    return kt.Target(logdensity_fn=lambda x: -0.5 * ((x @ PREC) * x).sum(-1), dim=2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _run(target, sampler, n_steps, burnin, seed, x0=None, **kw):
    job = kt.MCJob(target, sampler, kt.MCRange(n_steps=n_steps, burnin=burnin), n_chains=C, **kw)
    return job.run(_gen(seed), torch.zeros(2) if x0 is None else x0)


def _check(chain, atol_mean=0.1, atol_cov=0.15):
    flat = chain.flat("value").numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(2), atol=atol_mean)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=atol_cov)


def test_mala_acceptance_rate_tuner():
    chain = _run(corr_target(), kt.MALA(driftstep=0.5), 4000, 1500, 0,
                 tuner=kt.AcceptanceRateTuner(targetrate=0.6))
    _check(chain, 0.08, 0.12)
    assert abs(float(kt.stats.acceptance(chain)) - 0.6) < 0.1


def test_am_adapts_to_target_covariance():
    chain = _run(corr_target(), kt.AM(corescale=2.88, t0=50), 5000, 2000, 0)
    _check(chain)
    cov = chain.final_state.C.mean(0).numpy()
    np.testing.assert_allclose(cov, COV, atol=0.25)
    assert chain.final_state.C.shape == (C, 2, 2)


def test_ram_hits_target_rate():
    chain = _run(corr_target(), kt.RAM(targetrate=0.234), 5000, 2000, 1)
    _check(chain)
    assert abs(float(kt.stats.acceptance(chain)) - 0.234) < 0.06
    S = chain.final_state.S
    sst = (S @ S.mT).mean(0)
    assert float(sst[0, 1] / torch.sqrt(sst[0, 0] * sst[1, 1])) > 0.3


def test_amwg_per_coordinate_adaptation():
    scales = torch.tensor([0.2, 5.0])
    target = kt.Target(logdensity_fn=lambda x: -0.5 * torch.square(x / scales).sum(-1), dim=2)
    chain = _run(target, kt.AMWG(sigma0=1.0), 5000, 2000, 2,
                 diagnostics=("accept", "logsigma", "accept_frac", "accept_vec"))
    flat = chain.flat("value").numpy()
    np.testing.assert_allclose(flat.std(axis=0), scales.numpy(), rtol=0.2)
    logsig = chain.final_state.tune.step.mean(0)
    assert float(logsig[1] - logsig[0]) > 1.0
    # accept is the sweep's accepted fraction; the (C, D) extras are recorded
    assert chain["accept"].dtype == torch.float32
    assert chain["logsigma"].shape == (3000, C, 2) and chain["accept_vec"].shape == (3000, C, 2)
    rate = float(kt.stats.acceptance(chain))
    assert abs(rate - float(chain["accept_vec"].mean())) < 1e-6
    # the adaptation never stops: after burnin both coordinates' rates keep
    # moving towards 0.44 (δ = 0.01 a batch, so they are not there yet)
    early = chain["accept_vec"][:1000].mean((0, 1))
    late = chain["accept_vec"][-1000:].mean((0, 1))
    assert float(early[0]) < float(late[0]) < 0.44 < float(late[1]) < float(early[1])


def test_amwg_truncated_support():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * torch.square(x).sum(-1), dim=2)
    chain = _run(target, kt.AMWG(sigma0=1.0, lower=0.0), 2000, 500, 3, x0=torch.full((2,), 0.5))
    flat = chain.flat("value").numpy()
    assert flat.min() >= 0.0
    np.testing.assert_allclose(flat.mean(axis=0), np.full(2, 0.7979), atol=0.08)


def test_slice_sampler():
    chain = _run(corr_target(), kt.SliceSampler(widths=1.0), 1500, 300, 4)
    _check(chain)
    assert float(kt.stats.acceptance(chain)) > 0.99


def test_ars_standard_normal():
    """ARS accepts random-walk jumps against the envelope with no MH
    correction, so its draws lie between target (sd 1) and envelope (sd 2);
    the same qualitative bounds as the JAX test."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * torch.square(x).sum(-1), dim=1)
    ars = kt.ARS(logproposal=lambda x: -0.5 * torch.square(x / 2.0).sum(-1), proposalscale=1.0,
                 jumpscale=1.5)
    chain = _run(target, ars, 4000, 1000, 5, x0=torch.zeros(1), diagnostics=("accept", "weight"))
    flat = chain.flat("value").numpy()
    assert abs(flat.mean()) < 0.12
    assert 0.85 < flat.std() < 1.5
    assert 0.1 < float(kt.stats.acceptance(chain)) < 0.95
    assert chain["weight"].shape == (3000, C)


def test_smmala_correlated_gaussian():
    chain = _run(corr_target(), kt.SMMALA(driftstep=1.0), 1000, 200, 6)
    _check(chain)
    assert float(kt.stats.acceptance(chain)) > 0.6
    # the metric of a Gaussian is its precision, everywhere
    torch.testing.assert_close(chain.final_state.tensor[0], PREC, rtol=1e-4, atol=1e-5)


def test_smmala_softabs_on_nonconvex():
    target = kt.Target(
        logdensity_fn=lambda x: -0.25 * torch.square(torch.square(x) - 1.0).sum(-1), dim=1)
    chain = _run(target, kt.SMMALA(driftstep=0.5, transform="softabs"), 1000, 200, 7,
                 x0=torch.full((1,), 0.5))
    flat = chain.flat("value").numpy()
    assert np.all(np.isfinite(flat))
    assert (flat > 0.5).mean() > 0.1 and (flat < -0.5).mean() > 0.1


# ---------------------------------------------- NUTS on other position ranks
@pytest.mark.parametrize("impl", ["looped", "static"])
def test_nuts_standalone_scalar_position(impl):
    """Direct kernel use on 0-d per-chain positions, (C,): no lift."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * x**2)
    sampler = kt.NUTS(leapstep=0.5, tree_impl=impl)
    gen = _gen(0)
    state = sampler.init(target, torch.full((C,), 0.5), gen, step_size=0.5)
    assert state.position.shape == (C,) and state.inv_mass.shape == (C,)
    draws = []
    for _ in range(120):
        state, info = sampler.step(state, target, gen)
        draws.append(state.position)
    draws = torch.stack(draws[20:])
    assert draws.shape == (100, C) and info.accept.shape == (C,)
    assert abs(float(draws.mean())) < 0.1
    assert abs(float(draws.std()) - 1.0) < 0.1


@pytest.mark.parametrize("impl", ["looped", "static"])
def test_nuts_standalone_matrix_position(impl):
    """Direct kernel use on rank-2 per-chain positions, (C, 2, 3): the u-turn
    products sum over every element of a chain's position."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x**2).sum((-2, -1)))
    sampler = kt.NUTS(leapstep=0.5, tree_impl=impl)
    gen = _gen(1)
    state = sampler.init(target, torch.full((C, 2, 3), 0.5), gen, step_size=0.5)
    draws = []
    for _ in range(120):
        state, info = sampler.step(state, target, gen)
        draws.append(state.position)
    flat = torch.stack(draws[20:]).reshape(-1, 6)
    assert state.position.shape == (C, 2, 3)
    assert float(flat.mean(0).abs().max()) < 0.1
    assert float((flat.std(0) - 1.0).abs().max()) < 0.1
    # depth is per chain, not per element: every chain ran whole trees
    assert info.extras["ndoublings"].shape == (C,)


def test_nuts_tree_forms_agree_on_matrix_positions():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x**2).sum((-2, -1)))
    static, looped = (kt.NUTS(leapstep=0.4, tree_impl=t, max_doublings=4)
                      for t in ("static", "looped"))
    gen = _gen(2)
    state = static.init(target, torch.randn(C, 2, 3, generator=gen), gen, step_size=0.4)
    for _ in range(5):
        draws = static.draws(gen, state)
        new_s, info_s = static.step(state, target, draws=draws)
        new_l, info_l = looped.step(state, target, draws=draws)
        assert torch.equal(new_s.position, new_l.position)
        assert torch.equal(info_s.extras["na"], info_l.extras["na"])
        state = new_s


def test_hmc_runs_on_scalar_positions():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * x**2)
    hmc = kt.HMC(leapstep=0.4, nleaps=5)
    gen = _gen(3)
    state = hmc.init(target, torch.zeros(C), gen, step_size=0.4)
    draws = []
    for _ in range(150):
        state, _ = hmc.step(state, target, gen)
        draws.append(state.position)
    draws = torch.stack(draws[30:])
    assert draws.shape == (120, C)
    assert abs(float(draws.mean())) < 0.1 and abs(float(draws.std()) - 1.0) < 0.1


def test_nested_gibbs_block_on_a_scalar_parameter():
    """A 0-d per-chain Gibbs parameter, (C,), sampled by a nested HMC and a
    nested NUTS block on its conditional N(m, 1) given the carried m."""
    from klara_tpu_torch import distributions as td

    def model():
        m = kt.GibbsParameter("m", setpdf=lambda v: td.Normal(0.5 * v["p"], 1.0))
        p = kt.GibbsParameter("p", logtarget=lambda x, v: -0.5 * torch.square(x - v["m"]))
        return kt.GenericModel([m, p])

    for sampler in (kt.HMC(leapstep=0.5, nleaps=4), kt.NUTS(leapstep=0.5, max_doublings=3)):
        job = kt.GibbsJob(model(), {"p": kt.Nested(sampler, n_steps=2, step_size=0.5)},
                          kt.MCRange(n_steps=400, burnin=100), n_chains=C, device="cpu")
        out = job.run(_gen(4), {"m": 0.0, "p": 0.0})
        assert out["p"].shape == (300, C)
        # stationary: m ~ N(0, 4/3), p ~ N(0, 7/3)
        assert abs(float(out["p"].mean())) < 0.2
        assert abs(float(out["p"].var()) - 7.0 / 3.0) < 0.4


# ------------------------------------------- reference behaviours, pinned
def test_am_contracts_an_exact_ensemble_in_both_packages():
    """Haario's AM feeds the chain's current point into its proposal
    covariance, so at a finite count k its kernel is not reversible: an
    ensemble started from exact draws of a 20-dim normal contracts, in the
    JAX package and in the port alike (C0 the true covariance, t0 = burnin =
    100, 600 post steps at thinning 4, 1024 chains; the per-dim sd over the
    truth's has a standard error of ~0.5%).  Run with ``-s`` to see both
    ranges."""
    import jax
    import jax.numpy as jnp

    import klara_tpu as jkt

    D, chains, t0, post = 20, 1024, 100, 600
    rng = np.random.default_rng(0)
    a = rng.standard_normal((D, D))
    prec = (a @ a.T / D + 0.05 * np.eye(D)).astype(np.float32)
    cov = np.linalg.inv(prec).astype(np.float32)
    x0 = (rng.standard_normal((chains, D)) @ np.linalg.cholesky(cov).T).astype(np.float32)
    sd_true = np.sqrt(np.diag(cov))
    kw = dict(corescale=2.38**2 / D, minorscale=2.38**2 / D * float(np.diag(cov).mean()), t0=t0)
    rng_kw = dict(n_steps=t0 + post, burnin=t0, thinning=4)

    jp = jnp.asarray(prec)
    jjob = jkt.MCJob(jkt.Target(lambda x: -0.5 * x @ jp @ x, dim=D),
                     jkt.AM(C0=jnp.asarray(cov), **kw), jkt.MCRange(**rng_kw),
                     n_chains=chains, monitor=("value",))
    jv = np.asarray(jjob.run(jax.random.key(1), jnp.asarray(x0)).value).reshape(-1, D)
    tp = torch.tensor(prec)
    tjob = kt.MCJob(kt.Target(lambda x: -0.5 * ((x @ tp) * x).sum(-1), dim=D),
                    kt.AM(C0=torch.tensor(cov), **kw), kt.MCRange(**rng_kw),
                    n_chains=chains, monitor=("value",))
    tv = tjob.run(_gen(1), torch.tensor(x0)).value.reshape(-1, D).numpy()
    jr, tr = jv.std(0) / sd_true, tv.std(0) / sd_true
    print(f"AM sd over the truth's, k in {t0}..{t0 + post}: JAX {jr.min():.3f}..{jr.max():.3f}, "
          f"port {tr.min():.3f}..{tr.max():.3f}")
    assert jr.max() < 0.93 and tr.max() < 0.93          # both contract
    assert abs(jr.mean() - tr.mean()) < 0.02            # and alike
    assert x0.std(0).min() / sd_true.max() > 0.0 and abs((x0.std(0) / sd_true).mean() - 1) < 0.02


def test_smmala_drift_step_on_a_normal_matches_theory():
    """With the exact metric of a 100-dim normal, pooled dual averaging at
    0.574 lands the drift step near the optimal-scaling value 1.65²·D^-⅓ =
    0.59 (the bench logreg target, whose Hessian changes within a posterior
    sd, takes 0.002 on the card)."""
    D = 100
    g = _gen(0)
    a = torch.randn(D, D, generator=g)
    prec = a @ a.T / D + 0.1 * torch.eye(D)
    chol = torch.linalg.cholesky(torch.linalg.inv(prec))
    target = kt.Target(lambda x: -0.5 * ((x @ prec) * x).sum(-1), dim=D,
                       tensor_fn=lambda x: prec.expand(x.shape[0], D, D))
    job = kt.MCJob(target, kt.SMMALA(driftstep=0.5), kt.MCRange(n_steps=400, burnin=300),
                   tuner=kt.DualAveragingTuner(0.574, 300), n_chains=C, pooled_tuning=True,
                   monitor=("value",))
    chain = job.run(g, torch.randn(C, D, generator=g) @ chol.T)
    eps = float(chain.final_state.tune.step.mean())
    print(f"SMMALA drift step on a {D}-dim normal: {eps:.4f}")
    assert abs(eps - 1.65**2 * D ** (-1 / 3)) < 0.1
    assert abs(float(kt.stats.acceptance(chain)) - 0.574) < 0.08
