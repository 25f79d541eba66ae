"""GibbsJob, the model graph and the rats model of the port against
klara_tpu, plus the port's counterparts of the JAX package's Gibbs tests.

Exact checks (f32 on both sides):
* every rats full conditional's parameters against ``jax.vmap(setpdf)`` on
  the same values, at C = 30 (= the number of rats, where a missing
  ``[:, None]`` would broadcast silently) and at C = 7, rtol 1e-5;
* one whole rats sweep with JAX's draws replayed (the standard normal and
  standard gamma each block transforms, rebuilt from JAX's key schedule)
  against ``jax.vmap(job._sweep_fn)``, rtol 2e-5 (seven blocks in sequence,
  each a few f32 reductions whose order differs);
* ``rats_joint_target`` value and gradient against JAX's, rtol 2e-5;
* ``to_dot`` strings, equal.
The sampling tests are statistical, with the JAX tests' tolerances."""

import math

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

RATS_CARRY = ("alpha", "beta", "alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")


def _rats_values(C, seed=0):
    """A plausible per-chain rats state, seeded numpy f32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "alpha": (240 + 15 * rng.standard_normal((C, 30))).astype(f),
        "beta": (6 + 0.5 * rng.standard_normal((C, 30))).astype(f),
        "alpha_c": (242 + rng.standard_normal(C)).astype(f),
        "beta_c": (6.2 + 0.1 * rng.standard_normal(C)).astype(f),
        "sigma2_c": rng.uniform(20, 60, C).astype(f),
        "sigma2_a": rng.uniform(100, 300, C).astype(f),
        "sigma2_b": rng.uniform(0.1, 0.5, C).astype(f),
    }


def _full(a, shape):
    """A JAX per-chain parameter (C, *s) broadcast to the value shape
    (C, *F): its per-chain shape aligns right, as under vmap."""
    a = np.asarray(a)
    if a.ndim == 0:
        return np.broadcast_to(a, shape)
    return np.broadcast_to(a.reshape((a.shape[0],) + (1,) * (len(shape) - a.ndim) + a.shape[1:]),
                           shape)


@pytest.mark.parametrize("C", [30, 7])
def test_rats_conditional_parameters_match_jax(C):
    jmodel, jv0 = jex.rats_gibbs_model()
    tmodel, tv0 = tex.rats_gibbs_model(device="cpu")
    vals = _rats_values(C, seed=C)
    jvals = {k: jnp.asarray(v) for k, v in vals.items()}
    tvals = {k: torch.tensor(v) for k, v in vals.items()}
    for key in RATS_CARRY:
        shape = vals[key].shape
        jdist = jax.jit(jax.vmap(jmodel[key].setpdf))(jvals)
        tdist = tmodel[key].setpdf(tvals)
        assert type(jdist).__name__ == type(tdist).__name__
        for field in ("loc", "scale") if isinstance(tdist, td.Normal) else ("shape", "scale"):
            out = np.broadcast_to(np.asarray(getattr(tdist, field)), shape)
            np.testing.assert_allclose(out, _full(getattr(jdist, field), shape), rtol=1e-5,
                                       err_msg=f"{key}.{field}")


def test_rats_sweep_matches_jax_with_replayed_draws():
    C, i = 30, 3
    jmodel, jv0 = jex.rats_gibbs_model()
    tmodel, tv0 = tex.rats_gibbs_model(device="cpu")
    jjob = jkt.GibbsJob(jmodel, {}, jkt.MCRange(n_steps=10), n_chains=C)
    tjob = kt.GibbsJob(tmodel, {}, kt.MCRange(n_steps=10), n_chains=C)
    vals = _rats_values(C, seed=1)
    static = {"Y": jv0["Y"], "x": jv0["x"]}
    chain_keys = jax.random.split(jax.random.key(4), C)
    ref, _ = jax.jit(jax.vmap(lambda ck, dyn: jjob._sweep_fn(ck, {**static, **dyn}, i, {})))(
        chain_keys, {k: jnp.asarray(v) for k, v in vals.items()})

    # the standard draw each block transforms, from JAX's key schedule
    def block_draws(chain_keys):
        out = {}
        for b, var in enumerate(jjob._dependents):
            bkeys = jax.vmap(lambda ck: jax.random.fold_in(jax.random.fold_in(ck, i), b))(
                chain_keys)
            if var.key.startswith("sigma2"):
                a = 1e-3 + 0.5 * (150 if var.key == "sigma2_c" else 30)
                out[var.key] = jax.vmap(lambda k: jax.random.gamma(k, a, ()))(bkeys)
            else:
                shape = vals[var.key].shape[1:]
                out[var.key] = jax.vmap(lambda k: jax.random.normal(k, shape))(bkeys)
        return out

    noise = {k: torch.tensor(np.asarray(z)) for k, z in jax.jit(block_draws)(chain_keys).items()}

    tstatic = {"Y": tv0["Y"], "x": tv0["x"]}
    out, _ = tjob._sweep({**tstatic, **{k: torch.tensor(v) for k, v in vals.items()}},
                         torch.Generator().manual_seed(0), {}, noise=noise)
    for key in RATS_CARRY:
        assert out[key].dtype == torch.float32 and tuple(out[key].shape) == vals[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=2e-5,
                                   err_msg=key)


def test_rats_joint_target_value_and_grad_match_jax():
    jt, jdim, _ = jex.rats_joint_target()
    tt, tdim, unpack = tex.rats_joint_target(device="cpu")
    assert jdim == tdim == 65
    vals = _rats_values(9, seed=2)
    p = np.concatenate([vals["alpha"], vals["beta"], vals["alpha_c"][:, None],
                        vals["beta_c"][:, None],
                        np.log(np.stack([vals[k] for k in ("sigma2_c", "sigma2_a", "sigma2_b")],
                                        1))], 1).astype(np.float32)
    jv, jg = jax.jit(jax.vmap(jt.logdensity_and_grad))(jnp.asarray(p))
    tv, tg = tt.logdensity_and_grad(torch.tensor(p))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2e-5, atol=1e-3)
    assert unpack(torch.tensor(p))["log_s2_b"].shape == (9,)


def _dot_models(pkg, dist):
    p = pkg.GibbsParameter("p", setpdf=lambda v: dist.Normal(0.0, 1.0))
    q = pkg.GibbsParameter("q", logtarget=lambda x, v: -0.5 * (x - v["p"]) ** 2)
    t = pkg.Transformation("t", lambda v: v["p"] ** 2)
    model = pkg.GenericModel([pkg.Data("y"), pkg.Hyperparameter("h"), p, q, t],
                             [("y", "p"), ("p", "q"), ("p", "t")])
    job = pkg.GibbsJob(model, {"q": pkg.Nested(pkg.MH(0.5), n_steps=2)}, pkg.MCRange(n_steps=10),
                       monitor=["p", "q"], outopts={"q": {"destination": "none"}})
    lik = pkg.likelihood_model([pkg.Data("y"), pkg.Hyperparameter("h"), p])
    return model, job, lik


def test_to_dot_matches_jax():
    jm, jj, jl = _dot_models(jkt, jd)
    tm, tj, tl = _dot_models(kt, td)
    assert tm.to_dot() == jm.to_dot()
    assert tj.to_dot() == jj.to_dot()
    assert tl.to_dot("lik") == jl.to_dot("lik") and tl.parents_of("p") == ["y", "h"]
    assert '"q" [shape=circle, peripheries=2, style=diagonals];' in tj.to_dot()


def _bvn_model(rho=0.8, p1=None):
    def cond(other):
        return lambda v: td.Normal(v["rho"] * v[other], torch.sqrt(1 - v["rho"] ** 2))

    p1 = p1 or kt.GibbsParameter("p1", setpdf=cond("p2"))
    return kt.GenericModel([kt.Hyperparameter("rho"), p1, kt.GibbsParameter("p2", setpdf=cond("p1"))])


def _corr_sd(chains, key="p1", other="p2"):
    x1 = chains.flat(key).double().reshape(-1).numpy()
    x2 = chains.flat(other).double().reshape(-1).numpy()
    return np.corrcoef(x1, x2)[0, 1], np.std(x1)


def test_bivariate_normal_gibbs():
    job = kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=4000, burnin=1000), n_chains=16,
                      device="cpu")
    chains = job.run(torch.Generator().manual_seed(0), {"rho": 0.8, "p1": 5.1, "p2": 2.3})
    assert chains.samples["p1"].shape == (3000, 16)
    x1 = chains.flat("p1").numpy()
    assert abs(x1.mean()) < 0.1
    corr, sd = _corr_sd(chains)
    np.testing.assert_allclose(sd, 1.0, atol=0.1)
    np.testing.assert_allclose(corr, 0.8, atol=0.05)


def test_gibbs_trace_dtype_bf16():
    job = kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=3000, burnin=500), n_chains=16,
                      trace_dtype="bfloat16", device="cpu")
    chains = job.run(torch.Generator().manual_seed(0), {"rho": 0.8, "p1": 5.1, "p2": 2.3})
    assert chains.samples["p1"].dtype == torch.bfloat16
    assert chains.final_values["p1"].dtype == torch.float32  # only the saved copy rounds
    np.testing.assert_allclose(_corr_sd(chains)[0], 0.8, atol=0.05)
    with pytest.raises(ValueError, match="trace_dtype"):
        kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=10), trace_dtype="bfloat61")


def test_gibbs_resume_continues_from_final_values():
    v0 = {"rho": 0.8, "p1": 0.0, "p2": 0.0}
    job = kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=1500, burnin=500), n_chains=16,
                      device="cpu")
    gen = torch.Generator().manual_seed(7)
    first = job.run(gen, v0)
    second = job.resume(gen, first, v0)
    assert second.samples["p1"].shape == first.samples["p1"].shape
    assert not torch.allclose(second.final_values["p1"], first.final_values["p1"])
    corr, sd = _corr_sd(second)
    np.testing.assert_allclose(corr, 0.8, atol=0.08)
    np.testing.assert_allclose(sd, 1.0, atol=0.12)


def test_transformation_block():
    p = kt.GibbsParameter("p", setpdf=lambda v: td.Normal(0.0, 1.0))
    t = kt.Transformation("t", transform=lambda v: torch.square(v["p"]))
    model = kt.GenericModel([p, t], edges=[("p", "t")])
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=2000, burnin=100), n_chains=8,
                      device="cpu")
    chains = job.run(torch.Generator().manual_seed(3), {"p": 0.0, "t": 0.0})
    tt = chains.flat("t").numpy()
    np.testing.assert_allclose(tt.mean(), 1.0, atol=0.1)  # E[p²] = 1
    np.testing.assert_allclose(tt, np.square(chains.flat("p").numpy()), rtol=1e-6)
    # a constant-parameter conditional still draws independently per chain
    assert len(np.unique(chains.final_values["p"].numpy())) == 8


def test_data_update_hook_fires_before_the_blocks():
    """A counter Data vertex advanced by its hook each sweep; p is drawn
    tightly around it in the same sweep.  Python ints become int32 and
    floats f32; a float64 carried value keeps its dtype (draws are cast)."""
    count = kt.Data("count", update=lambda v: v["count"] + 1)
    p = kt.GibbsParameter("p", setpdf=lambda v: td.Normal(v["count"].to(torch.float32), 1e-3))
    q = kt.GibbsParameter("q", setpdf=lambda v: td.Normal(v["p"], 1.0))
    job = kt.GibbsJob(kt.GenericModel([count, p, q]), {}, kt.MCRange(n_steps=20, burnin=5),
                      n_chains=4, monitor=["p", "q", "count"], device="cpu")
    chains = job.run(torch.Generator().manual_seed(0),
                     {"count": 0, "p": 0.0, "q": torch.zeros((), dtype=torch.float64)})
    assert chains.final_values["count"].dtype == torch.int32
    assert torch.equal(chains.final_values["count"], torch.full((4,), 20, dtype=torch.int32))
    assert chains.samples["p"].dtype == torch.float32
    assert chains.samples["q"].dtype == torch.float64
    want = torch.arange(6, 21, dtype=torch.float32)[:, None].expand(15, 4)
    torch.testing.assert_close(chains.samples["p"], want, rtol=0, atol=0.01)
    torch.testing.assert_close(chains.samples["count"], want.to(torch.int32))


def _mwg_model(rho=0.8, setprior=None):
    p1 = kt.GibbsParameter(
        "p1",
        logtarget=lambda x, v: -0.5 * torch.square(x - v["rho"] * v["p2"]).sum(-1)
        / (1 - v["rho"] ** 2),
        setprior=setprior,
    )
    return _bvn_model(rho, p1=p1)


MWG_V0 = {"rho": 0.8, "p1": np.zeros(1, np.float32), "p2": np.zeros(1, np.float32)}


def test_gibbs_nested_mh_acceptance_diagnostics():
    job = kt.GibbsJob(_mwg_model(), {"p1": kt.Nested(kt.MH(sigma=0.8), n_steps=5)},
                      kt.MCRange(n_steps=2000, burnin=500), n_chains=8, device="cpu")
    chains = job.run(torch.Generator().manual_seed(4), MWG_V0)
    acc = chains["p1.accept"].numpy()
    assert acc.shape == (chains.samples["p1"].shape[0], 8)
    assert 0.2 < acc.mean() < 0.95
    np.testing.assert_allclose(acc * 5, np.round(acc * 5), atol=1e-5)  # fractions of 5 steps
    corr, sd = _corr_sd(chains)
    np.testing.assert_allclose(corr, 0.8, atol=0.07)
    np.testing.assert_allclose(sd, 1.0, atol=0.12)
    no_diag = kt.GibbsJob(_mwg_model(), {"p1": kt.Nested(kt.MH(sigma=0.8))},
                          kt.MCRange(n_steps=20), n_chains=2, record_diagnostics=False,
                          device="cpu")
    assert no_diag.run(torch.Generator().manual_seed(0), MWG_V0).diagnostics == {}


def test_gibbs_nested_tuner_and_reset_from_prior():
    """The nested AcceptanceRateTuner adapts per chain during the nested
    burnin; nested starts are drawn from the prior every sweep (so each
    sweep's 20 nested steps must forget a fresh start)."""
    spec = kt.Nested(kt.MH(sigma=0.5), n_steps=20, burnin=10,
                     tuner=kt.AcceptanceRateTuner(targetrate=0.44, period=5),
                     reset_from_prior=True)
    job = kt.GibbsJob(_mwg_model(setprior=lambda v: td.Normal(0.0, 1.5)), {"p1": spec},
                      kt.MCRange(n_steps=500, burnin=100), n_chains=32, device="cpu")
    chains = job.run(torch.Generator().manual_seed(5), MWG_V0)
    corr, sd = _corr_sd(chains)
    np.testing.assert_allclose(corr, 0.8, atol=0.08)
    np.testing.assert_allclose(sd, 1.0, atol=0.12)


@pytest.mark.parametrize("sampler", ["HMC", "NUTS"])
def test_init_tune_takes_a_per_chain_step_size(sampler):
    target = tex.normal_target(3)
    step = torch.linspace(0.1, 0.8, 5)
    state = getattr(kt, sampler)().init(target, torch.zeros(5, 3), step_size=step,
                                        tuner=kt.DualAveragingTuner(0.8))
    torch.testing.assert_close(state.tune.step, step)
    torch.testing.assert_close(state.tune.extra.mu, torch.log(10.0 * step))


def test_gibbs_nested_hmc_with_the_hoisted_step_search(monkeypatch):
    """HMC under dual averaging with no step size: one search per run, its
    per-chain ε handed to every sweep's init; the run samples the target."""
    seen = []
    init = kt.HMC.init

    def spy(self, target, position, generator=None, step_size=None, tuner=None, **kw):
        seen.append(step_size)
        return init(self, target, position, generator, step_size, tuner, **kw)

    monkeypatch.setattr(kt.HMC, "init", spy)
    spec = kt.Nested(kt.HMC(leapstep=0.1, nleaps=4), n_steps=6, burnin=3,
                     tuner=kt.DualAveragingTuner(0.8, 3))
    job = kt.GibbsJob(_mwg_model(), {"p1": spec}, kt.MCRange(n_steps=400, burnin=100),
                      n_chains=32, device="cpu")
    assert job.sweep["p1"].sampler.dynamic_nleaps
    assert job._needs_step_hoist(job.sweep["p1"])
    assert not job._needs_step_hoist(kt.Nested(kt.HMC(), step_size=0.1,
                                               tuner=kt.DualAveragingTuner(0.8, 3)))
    chains = job.run(torch.Generator().manual_seed(7), MWG_V0)
    assert len(seen) == 400 and all(s is seen[0] for s in seen)
    assert seen[0].shape == (32,) and len(torch.unique(seen[0])) > 1
    corr, sd = _corr_sd(chains)
    np.testing.assert_allclose(corr, 0.8, atol=0.08)
    np.testing.assert_allclose(sd, 1.0, atol=0.12)


def test_gibbs_outopts_none_keeps_the_final_value_only():
    job = kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=40, burnin=10), n_chains=4,
                      outopts={"p2": {"destination": "none"}}, device="cpu")
    chains = job.run(torch.Generator().manual_seed(6), {"rho": 0.8, "p1": 0.0, "p2": 0.0})
    assert "p2" not in chains.samples and "p2" in chains.final_values
    assert chains.samples["p1"].shape == (30, 4)


def _single():
    return kt.GenericModel([kt.GibbsParameter("p", setpdf=lambda v: td.Normal(0.0, 1.0))])


@pytest.mark.parametrize("case", ["csv", "csv_no_path", "bogus", "unmonitored", "setprior",
                                  "unknown_key"])
def test_gibbs_job_validation_errors(case, tmp_path):
    rng = kt.MCRange(n_steps=10)
    if case == "csv":  # a csv variable with a filepath builds and streams
        out = str(tmp_path / "p")
        job = kt.GibbsJob(_single(), {}, kt.MCRange(n_steps=5), n_chains=3, device="cpu",
                          outopts={"p": {"destination": "csv", "filepath": out}})
        chains = job.run(torch.Generator().manual_seed(0), {"p": 0.0})
        assert chains.samples == {}
        back = kt.io.read_chain(out, device="cpu")
        assert back["p"].shape == (5, 3) and bool(torch.isfinite(back["p"]).all())
    elif case == "csv_no_path":
        with pytest.raises(ValueError, match="filepath"):
            kt.GibbsJob(_single(), {}, rng, outopts={"p": {"destination": "csv"}})
    elif case == "bogus":
        with pytest.raises(ValueError, match="unknown destination"):
            kt.GibbsJob(_single(), {}, rng, outopts={"p": {"destination": "bogus"}})
    elif case == "unmonitored":
        with pytest.raises(ValueError, match="unmonitored"):
            kt.GibbsJob(_bvn_model(), {}, rng, monitor=["p1"],
                        outopts={"p2": {"destination": "none"}})
    elif case == "setprior":
        p = kt.GibbsParameter("p", logtarget=lambda x, v: -0.5 * (x * x).sum(-1))
        with pytest.raises(ValueError, match="setprior"):
            kt.GibbsJob(kt.GenericModel([p]), {"p": kt.Nested(kt.MH(), reset_from_prior=True)},
                        rng)
    else:
        with pytest.raises(ValueError, match="unknown variable"):
            kt.GibbsJob(_single(), {"zz": kt.Nested(kt.MH())}, rng)


def test_gibbs_missing_v0_raises():
    model = kt.GenericModel([kt.Data("y"), kt.GibbsParameter("p", setpdf=lambda v: td.Normal())])
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=10), device="cpu")
    with pytest.raises(ValueError, match="missing"):
        job.run(torch.Generator(), {"p": 0.0})
    with pytest.raises(ValueError, match="setpdf"):
        kt.GibbsJob(kt.GenericModel([kt.GibbsParameter("p")]), {}, kt.MCRange(n_steps=2),
                    device="cpu").run(
            torch.Generator(), {"p": 0.0})


def test_gamma_conditional_shares_its_draw_within_a_chain_as_in_jax():
    """Gamma(shape=3, rate=vector): JAX draws its shape from the scalar
    shape parameter, so the vector shares one gamma draw per chain (a
    reference behaviour); the port's job does the same, per chain."""
    rate = np.array([1.0, 2.0, 4.0], np.float32)
    C = 5

    def model(pkg, dist, r):
        return pkg.GenericModel([pkg.GibbsParameter("g", setpdf=lambda v: dist.Gamma(3.0, r))])

    jchains = jkt.GibbsJob(model(jkt, jd, jnp.asarray(rate)), {}, jkt.MCRange(n_steps=3),
                           n_chains=C).run(jax.random.key(0), {"g": jnp.zeros(3)})
    tchains = kt.GibbsJob(model(kt, td, torch.tensor(rate)), {}, kt.MCRange(n_steps=3),
                          n_chains=C, device="cpu").run(torch.Generator().manual_seed(0),
                                          {"g": np.zeros(3, np.float32)})
    for g in (np.asarray(jchains.samples["g"]), tchains.samples["g"].numpy()):
        assert g.shape == (3, C, 3)
        scaled = g * rate
        np.testing.assert_allclose(scaled, np.repeat(scaled[..., :1], 3, -1), rtol=1e-6)
        assert len(np.unique(scaled[..., 0])) == 3 * C  # independent across chains and sweeps


def test_conditionals_draw_from_the_keyed_stream_at_sweep_and_block():
    """Block b of sweep i draws from the run's keyed stream at counter
    (i, b), whose key is the generator's first draw of the run: two
    standard-normal blocks rebuilt from the stream, bit for bit."""
    from klara_tpu_torch.ops.keyed import KeyedStream, run_key

    model = kt.GenericModel([kt.GibbsParameter("a", setpdf=lambda v: td.Normal(0.0, 1.0)),
                             kt.GibbsParameter("b", setpdf=lambda v: td.Normal(0.0, 1.0))])
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=4, burnin=0), n_chains=8, device="cpu")
    chains = job.run(torch.Generator().manual_seed(2), {"a": 0.0, "b": 0.0})
    stream = KeyedStream(run_key(torch.Generator().manual_seed(2), "cpu"), 8)
    for i in range(4):
        for block, key in enumerate(("a", "b")):
            want = stream.at(step=i, site=block).normal((8,))
            torch.testing.assert_close(chains.samples[key][i], want, rtol=0, atol=0)


def test_resume_from_jax_chains_through_convert():
    """JAX GibbsChains (bf16 trace) as numpy -> the port's, resumed there."""
    from klara_tpu_torch import convert

    def cond(other):
        return lambda v: jd.Normal(v["rho"] * v[other], jnp.sqrt(1 - v["rho"] ** 2))

    jmodel = jkt.GenericModel([jkt.Hyperparameter("rho"), jkt.GibbsParameter("p1", setpdf=cond("p2")),
                               jkt.GibbsParameter("p2", setpdf=cond("p1"))])
    v0 = {"rho": np.float32(0.8), "p1": 1.0, "p2": 2.0}
    jchains = jkt.GibbsJob(jmodel, {}, jkt.MCRange(n_steps=20), n_chains=4,
                           trace_dtype="bfloat16").run(jax.random.key(0), v0)
    tchains = convert.gibbs_chains_from_numpy(jax.tree.map(np.asarray, jchains), device="cpu")
    assert tchains.samples["p1"].dtype == torch.bfloat16 and tchains.samples["p1"].shape == (20, 4)
    np.testing.assert_array_equal(tchains.final_values["p2"].numpy(),
                                  np.asarray(jchains.final_values["p2"]))
    out = kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=5), n_chains=4, device="cpu").resume(
        torch.Generator().manual_seed(0), tchains, convert.gibbs_values_from_numpy(v0, device="cpu"))
    assert out.samples["p1"].shape == (5, 4) and out.final_values["p1"].dtype == torch.float32


def test_gibbs_job_takes_its_device_from_v0():
    """With no ``device`` the job keeps v0's tensors where they are (here
    the meta device stands in for the card) and never moves them to the
    CPU; a device given explicitly must hold v0's tensors."""
    model, v0 = tex.rats_gibbs_model(device="cpu")
    meta = {k: v.to("meta") for k, v in v0.items()}
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=3), n_chains=4)
    values = job._initial_values({**meta, "alpha_c": 150.0}, prebatched=False)
    assert {t.device.type for t in values.values()} == {"meta"}
    assert values["alpha"].shape == (4, 30) and values["alpha_c"].shape == (4,)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        job._device_of({"alpha_c": 150.0})  # no tensor, no device, no card here
    with pytest.raises(ValueError, match="job's device is cpu"):
        kt.GibbsJob(model, {}, n_chains=4, device="cpu")._initial_values(meta, prebatched=False)
    with pytest.raises(ValueError, match="several devices"):
        job._initial_values({**meta, "Y": v0["Y"]}, prebatched=False)
    out = job.run(torch.Generator().manual_seed(0), v0)  # CPU tensors stay on the CPU
    assert {t.device.type for t in (*out.samples.values(), *out.final_values.values())} == {"cpu"}
