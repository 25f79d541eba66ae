"""MCMC-within-Gibbs on the rats model in both packages: ``alpha`` as a
nested HMC block on its conditional, every other block conjugate.  The
port's model is ``rats_gibbs_model(nested_alpha=True)``; the JAX package's
is its ``rats_gibbs_model`` with the same ``alpha`` vertex swapped in.  The
block has the settings of benchmarks/gibbs_hoist_probe.py,
``Nested(HMC(leapstep=0.05, nleaps=4), n_steps=4,
tuner=DualAveragingTuner(0.8, 4))``, so the step-size search is hoisted to
once per run and its per-chain ε reaches ``init_tune``.

The test runs both packages at C chains x SWEEPS sweeps and holds the
posterior means of alpha_c, beta_c and sigma2_c within 4x the combined
Monte Carlo standard error (per-chain Geyer IMSE variances of the chain
means), the mean nested acceptance within 0.02, and rank-R-hat under 1.05
in both.

Run as a script, it prints the reference that chip_smoke.py's phase 11
holds the port to (``JAX_NESTED``: the JAX package's posterior means and
their MCSE at phase 11's size), the port's own run at that size, and the
JAX package's conjugate means for comparison:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gibbs_nested.py [chains sweeps burnin]

(4096 chains x 2000 sweeps, 200 burnin by default; a few minutes on a CPU).
"""

import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch.models import examples as tex

C, SWEEPS, BURNIN = 128, 300, 100
KEYS = ("alpha_c", "beta_c", "sigma2_c")


def jax_nested_model():
    """The JAX package's rats model with ``alpha`` as a ``logtarget``
    vertex (benchmarks/gibbs_hoist_probe.py's conditional)."""
    model, v0 = jex.rats_gibbs_model()
    Y, xc = v0["Y"], v0["x"]

    def alpha_logtarget(x, v):
        resid = Y - x[:, None] - jnp.outer(v["beta"], xc)
        return (
            -0.5 * jnp.sum(jnp.square(resid)) / v["sigma2_c"]
            - 0.5 * jnp.sum(jnp.square(x - v["alpha_c"])) / v["sigma2_a"]
        )

    alpha = jkt.GibbsParameter("alpha", logtarget=alpha_logtarget)
    return jkt.GenericModel([alpha if v.key == "alpha" else v for v in model.vertices]), v0


def run_jax(chains, sweeps, burnin, seed=0, nested=True):
    model, v0 = jax_nested_model() if nested else jex.rats_gibbs_model()
    sweep = {"alpha": jkt.Nested(jkt.HMC(leapstep=0.05, nleaps=4), n_steps=4,
                                 tuner=jkt.DualAveragingTuner(0.8, 4))} if nested else {}
    return jkt.GibbsJob(model, sweep, jkt.MCRange(n_steps=sweeps, burnin=burnin),
                        n_chains=chains, monitor=KEYS).run(jax.random.key(seed), v0)


def run_port(chains, sweeps, burnin, seed=0):
    model, v0 = tex.rats_gibbs_model(nested_alpha=True, device="cpu")
    sweep = {"alpha": kt.Nested(kt.HMC(leapstep=0.05, nleaps=4), n_steps=4,
                                tuner=kt.DualAveragingTuner(0.8, 4))}
    job = kt.GibbsJob(model, sweep, kt.MCRange(n_steps=sweeps, burnin=burnin),
                      n_chains=chains, monitor=KEYS)
    assert job._needs_step_hoist(job.sweep["alpha"])
    return job.run(torch.Generator().manual_seed(seed), v0)


def summary(chains):
    """{key: (posterior mean, MCSE)} of either package's run, through the
    port's statistics (tests/test_torch_stats.py holds them to JAX's)."""
    out = {}
    for k in KEYS:
        x = torch.from_numpy(np.array(chains.samples[k]))
        mcse = np.sqrt(kt.stats.mcvar(x).numpy().mean(0) / x.shape[1])
        out[k] = (float(kt.stats.mean(x)), float(mcse))
    return out


def test_nested_rats_posterior_matches_jax():
    jchains, tchains = run_jax(C, SWEEPS, BURNIN), run_port(C, SWEEPS, BURNIN)
    js, ts = summary(jchains), summary(tchains)
    for k in KEYS:
        assert tchains.samples[k].shape == (SWEEPS - BURNIN, C)
        assert torch.isfinite(tchains.samples[k]).all()
        (mj, sej), (mt, set_) = js[k], ts[k]
        assert abs(mj - mt) < 4.0 * np.hypot(sej, set_), (k, js[k], ts[k])
        for x in (torch.from_numpy(np.array(jchains.samples[k])), tchains.samples[k]):
            assert float(kt.stats.rhat_rank(x).max()) < 1.05
    acc_j = float(jnp.mean(jchains["alpha.accept"]))
    acc_t = float(tchains["alpha.accept"].mean())
    assert tchains["alpha.accept"].shape == (SWEEPS - BURNIN, C)
    assert 0.2 < acc_t < 0.99 and abs(acc_j - acc_t) < 0.02, (acc_j, acc_t)


if __name__ == "__main__":
    chains, sweeps, burnin = (int(a) for a in (sys.argv[1:4] or (4096, 2000, 200)))
    print("JAX_NESTED =", json.dumps(summary(run_jax(chains, sweeps, burnin))), flush=True)
    print("port nested:", json.dumps(summary(run_port(chains, sweeps, burnin))), flush=True)
    print("JAX conjugate:", json.dumps(summary(run_jax(chains, sweeps, burnin, nested=False))))
