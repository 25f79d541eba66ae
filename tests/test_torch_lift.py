"""The port's scalar lift, monitor slots and job constructors, on the CPU:
counterparts of the JAX package's univariate tests (a 0-d ``x0``, per-chain
scalars with ``dim=1``, prior draws, every sampler on a univariate normal,
squeezed traces), the x0-ambiguity error, all 13 monitored slots against the
Target accessors and against the JAX package's recorded values, and
``MCJob.from_model``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
import klara_tpu_torch as kt
from klara_tpu_torch import distributions as td

MU = 1.5
SAMPLERS = [
    kt.MH(sigma=0.8),
    kt.MALA(driftstep=0.5),
    kt.HMC(leapstep=0.5, nleaps=5),
    kt.AM(),
    kt.RAM(),
    kt.AMWG(sigma0=0.8),
    kt.SliceSampler(widths=2.0),
    kt.SMMALA(driftstep=0.8),
    kt.NUTS(leapstep=0.5, max_doublings=3),
    # the envelope is the sampler's, not the target's: the lift does not wrap
    # it, so it is written for the lifted (C, 1) positions
    kt.ARS(logproposal=lambda x: -0.5 * torch.square((x - MU) / 2.0).sum(-1),
           proposalscale=1.0),
]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _uni_target(**kw):
    """A univariate target written for scalar positions: (C,) -> (C,)."""
    return kt.Target(logdensity_fn=lambda x: -0.5 * (x - MU) ** 2, dim=1, **kw)


@pytest.mark.parametrize("sampler", SAMPLERS, ids=lambda s: type(s).__name__)
def test_univariate_scalar_positions_all_samplers(sampler):
    """A 0-d x0 runs through every sampler by the dim-1 lift, the
    vector-only ones included, and the draw series come out scalar."""
    job = kt.MCJob(_uni_target(), sampler, kt.MCRange(n_steps=900, burnin=300), n_chains=32)
    chain = job.run(_gen(), torch.tensor(0.0))
    assert chain.value.shape == (600, 32)
    assert chain["logtarget"].shape == (600, 32) and chain["accept"].shape == (600, 32)
    assert chain.final_state.position.shape == (32, 1)  # the state stays lifted
    flat = chain.flat("value")
    if isinstance(sampler, kt.ARS):  # not exact: between target and envelope
        assert abs(float(flat.mean()) - MU) < 0.15 and 0.85 < float(flat.std()) < 1.6
    else:
        assert abs(float(flat.mean()) - MU) < 0.1
        assert abs(float(flat.std()) - 1.0) < 0.15


def test_univariate_per_chain_scalars_with_dim1():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * x**2, dim=1)
    job = kt.MCJob(target, kt.AM(), kt.MCRange(n_steps=800, burnin=200), n_chains=8)
    chain = job.run(_gen(1), torch.linspace(-2.0, 2.0, 8))
    assert chain.value.shape == (600, 8)
    assert abs(float(chain.flat("value").mean())) < 0.12


def test_run_phased_squeezes_too():
    job = kt.MCJob(_uni_target(), kt.MALA(0.9), kt.MCRange(n_steps=60, burnin=20), n_chains=4,
                   monitor=("value", "gradlogtarget", "tensorlogtarget"),
                   diagnostics=("accept", "accept_stat"), device="cpu")
    chain, timings = job.run_phased(_gen(), 0.0)  # a Python number is a 0-d x0
    assert chain.value.shape == (40, 4)
    assert chain["gradlogtarget"].shape == (40, 4)
    # only a trailing axis of length 1 is dropped, once: (n, C, 1, 1) -> (n, C, 1)
    assert chain["tensorlogtarget"].shape == (40, 4, 1)
    torch.testing.assert_close(chain["tensorlogtarget"], torch.ones(40, 4, 1))
    torch.testing.assert_close(chain["gradlogtarget"], MU - chain.value)
    assert set(timings) == {"warmup_seconds", "sampling_seconds"}


def test_scalar_prior_draws_lift_when_dim_is_unset():
    """A scalar prior with dim=None draws (C,) per-chain scalars, which
    lift; with dim=3 the same prior draws (C, 3) iid vectors and nothing is
    lifted; a multivariate prior draws its own event shape."""
    prior = td.Normal(MU, 1.0)
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x - MU) ** 2, prior=prior)
    assert target.sample_prior(_gen(), 5).shape == (5,)
    job = kt.MCJob(target, kt.RAM(), kt.MCRange(n_steps=400, burnin=100), n_chains=16,
                   monitor=("value", "logprior"), device="cpu")
    chain = job.run(_gen(2))
    assert chain.value.shape == (300, 16) and chain["logprior"].shape == (300, 16)
    assert job.target.dim == 1
    assert abs(float(chain.flat("value").mean()) - MU) < 0.25

    vec = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=3, prior=prior)
    assert vec.sample_prior(_gen(), 5).shape == (5, 3)
    job = kt.MCJob(vec, kt.MH(0.5), kt.MCRange(n_steps=20, burnin=5), n_chains=4, device="cpu")
    assert job.run(_gen(3)).value.shape == (15, 4, 3)

    mv = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2,
                   prior=td.MvNormal(torch.zeros(2), torch.eye(2)))
    assert mv.sample_prior(_gen(), 5).shape == (5, 2)


def test_lift_wraps_the_analytic_overrides():
    """grad_fn, value_and_grad_fn, tensor_fn and dtensor_fn of a scalar target
    are written for (C,) positions; lifted, they return (C, 1), (C, 1, 1) and
    (C, 1, 1, 1)."""
    calls = []

    def vg(x):
        calls.append("vg")
        return -0.5 * (x - MU) ** 2, MU - x

    target = _uni_target(
        grad_fn=lambda x: MU - x,
        value_and_grad_fn=vg,
        tensor_fn=lambda x: torch.ones_like(x),
        dtensor_fn=lambda x: torch.zeros_like(x),
        loglikelihood_fn=lambda x: -0.5 * (x - MU) ** 2,
        logprior_fn=lambda x: torch.zeros_like(x),
    )
    job = kt.MCJob(target, kt.SMMALA(driftstep=0.8), kt.MCRange(n_steps=30, burnin=10),
                   n_chains=6, monitor=("value", "dtensorlogtarget", "loglikelihood",
                                        "gradloglikelihood"))
    chain = job.run(_gen(), torch.tensor(0.3))
    x = torch.linspace(-1, 1, 6)[:, None]
    lifted = job.target
    assert lifted.grad(x).shape == (6, 1) and lifted.tensor(x).shape == (6, 1, 1)
    assert lifted.dtensor(x).shape == (6, 1, 1, 1)
    v, g = lifted.logdensity_and_grad(x)
    assert v.shape == (6,) and g.shape == (6, 1)
    assert chain.value.shape == (20, 6) and chain["gradloglikelihood"].shape == (20, 6)
    assert chain["dtensorlogtarget"].shape == (20, 6, 1, 1)
    assert chain.final_state.tensor.shape == (6, 1, 1)
    # lifting twice is a no-op
    job._lift_target()
    assert job.target is lifted


def test_ambiguous_x0_shape_raises():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1))  # dim unset
    job = kt.MCJob(target, kt.MH(), kt.MCRange(n_steps=20, burnin=0), n_chains=4)
    with pytest.raises(ValueError, match="ambiguous initial value"):
        job.run(_gen(), torch.zeros(4))


def test_x0_disambiguated_by_target_dim_and_shared_positions():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=4)
    job = kt.MCJob(target, kt.MH(), kt.MCRange(n_steps=50, burnin=10), n_chains=4)
    assert job.run(_gen(), torch.zeros(4)).value.shape == (40, 4, 4)
    # a rank-2 position shared by every chain
    mat = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum((-2, -1)))
    job = kt.MCJob(mat, kt.MH(0.5), kt.MCRange(n_steps=12, burnin=2), n_chains=5)
    assert job.run(_gen(), torch.zeros(2, 3)).value.shape == (10, 5, 2, 3)


def test_checkin_rejects_a_start_outside_the_support():
    target = kt.bounded_target(
        kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2), lower=0.0)
    job = kt.MCJob(target, kt.MH(), kt.MCRange(n_steps=5), n_chains=3)
    with pytest.raises(ValueError, match="out of support"):
        job.run(_gen(), torch.tensor([-1.0, 1.0]))
    with pytest.raises(ValueError, match="prior"):
        job.run(_gen())


# ---------------------------------------------------------- 13 monitor slots
FIELDS = (
    "value", "logtarget", "loglikelihood", "logprior",
    "gradlogtarget", "gradloglikelihood", "gradlogprior",
    "tensorlogtarget", "tensorloglikelihood", "tensorlogprior",
    "dtensorlogtarget", "dtensorloglikelihood", "dtensorlogprior",
)


def test_monitor_all_thirteen_slots_match_jax_accessors():
    """Every slot is recorded with its shape, and at the recorded positions
    each equals the JAX package's accessor of the same target (rtol 1e-5)."""
    jt = jkt.Target.from_loglik_logprior(
        lambda x: -0.5 * jnp.sum(x * x), lambda x: -0.25 * jnp.sum(x**4), dim=2)
    tt = kt.Target.from_loglik_logprior(
        lambda x: -0.5 * (x * x).sum(-1), lambda x: -0.25 * (x**4).sum(-1), dim=2)
    job = kt.MCJob(tt, kt.MH(0.5), kt.MCRange(n_steps=40, burnin=10), n_chains=4,
                   monitor=FIELDS)
    chain = job.run(_gen(), torch.zeros(2))
    n = 30
    shapes = {"value": (2,), "logtarget": (), "loglikelihood": (), "logprior": ()}
    for f in FIELDS:
        rank = 1 if f.startswith("grad") else 2 if f.startswith("tensor") else 3
        want = shapes.get(f, (2,) * rank)
        assert chain[f].shape == (n, 4) + want, f
    x_last = jnp.asarray(chain.value[-1].numpy())
    accessor = {
        "loglikelihood": jt.loglikelihood, "logprior": jt.logprior, "logtarget": jt.logdensity,
        "gradlogtarget": jt.grad, "gradloglikelihood": jt.grad_loglikelihood,
        "gradlogprior": jt.grad_logprior, "tensorlogtarget": jt.tensor,
        "tensorloglikelihood": jt.tensor_loglikelihood, "tensorlogprior": jt.tensor_logprior,
        "dtensorlogtarget": jt.dtensor, "dtensorloglikelihood": jt.dtensor_loglikelihood,
        "dtensorlogprior": jt.dtensor_logprior,
    }
    for f, fn in accessor.items():
        np.testing.assert_allclose(chain[f][-1].numpy(), np.asarray(jax.vmap(fn)(x_last)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # analytic spot checks: tensor_ll = I, tensor_lp = diag(3 x_i²)
    torch.testing.assert_close(chain["tensorloglikelihood"][-1, 0], torch.eye(2))
    torch.testing.assert_close(chain["tensorlogprior"][-1, 0],
                               torch.diag(3.0 * chain.value[-1, 0] ** 2))
    torch.testing.assert_close(
        chain["tensorlogtarget"], chain["tensorloglikelihood"] + chain["tensorlogprior"])


def test_unknown_monitor_and_diagnostic_raise():
    job = kt.MCJob(_uni_target(), kt.MH(), kt.MCRange(n_steps=4), n_chains=2,
                   monitor=("value", "hessian"))
    with pytest.raises(ValueError, match="unknown monitored field"):
        job.run(_gen(), torch.tensor(0.0))
    job = kt.MCJob(_uni_target(), kt.MH(), kt.MCRange(n_steps=4), n_chains=2,
                   diagnostics=("tune",))
    with pytest.raises(ValueError, match="unknown diagnostic"):
        job.run(_gen(), torch.tensor(0.0))


def test_state_fields_are_recordable_diagnostics():
    """A tensor field of the sampler's state is a per-draw diagnostic: AM's
    (C, D, D) covariance and its count."""
    target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2)
    job = kt.MCJob(target, kt.AM(t0=5), kt.MCRange(n_steps=30, burnin=10), n_chains=3,
                   diagnostics=("accept", "C", "count"))
    chain = job.run(_gen(), torch.zeros(2))
    assert chain["C"].shape == (20, 3, 2, 2)
    assert chain["count"][:, 0].tolist() == list(range(11, 31))


# ----------------------------------------------------------------- from_model
def test_from_model_builds_the_conditional_target():
    """A Poisson(λ) count sampled by MH with an integer random walk, built
    from the model graph and v0 (the JAX package's from_model test)."""
    lam = 6.0

    def logtarget(x, v):
        xf = x.to(torch.float32)
        return (xf * torch.log(v["lam"]) - torch.lgamma(xf + 1.0)).sum(-1)

    class Walk(td.Distribution):
        """x ± 1 with equal probability, reflected at 0."""

        def __init__(self, x):
            self.x = x

        def sample(self, rng, shape=()):
            # MH hands a proposal its keyed stream
            step = torch.where(rng.uniform(self.x.shape) < 0.5, -1, 1)
            return torch.where(self.x == 0, torch.ones_like(self.x), self.x + step.to(self.x.dtype))

        def logpdf(self, y):
            return torch.where(self.x == 0, 0.0, float(np.log(0.5))) * torch.ones(y.shape)

    model = kt.likelihood_model([kt.Constant("lam"), kt.GibbsParameter("p", logtarget=logtarget)])
    sampler = kt.MH(proposal_fn=lambda x, s: Walk(x), symmetric=False)
    job, x0 = kt.MCJob.from_model(
        model, sampler, kt.MCRange(n_steps=3000, burnin=500),
        v0={"lam": lam, "p": np.array([2], np.int32)}, n_chains=16, device="cpu")
    assert job.target.name == "p" and x0.dtype == torch.int32 and tuple(x0.shape) == (1,)
    chain = job.run(_gen(1), x0)
    assert chain.value.shape == (2500, 16, 1)
    assert abs(float(chain.flat("value").to(torch.float32).mean()) - lam) < 0.4

    two = kt.likelihood_model([kt.GibbsParameter("a", logtarget=logtarget),
                               kt.GibbsParameter("b", logtarget=logtarget)])
    with pytest.raises(ValueError, match="multiple parameters"):
        kt.MCJob.from_model(two, sampler, kt.MCRange(n_steps=3), v0={"a": 1, "b": 1},
                            device="cpu")
