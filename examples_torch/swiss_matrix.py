"""Swiss Bayesian logistic regression: the full sampler x AD matrix
(counterpart of examples/swiss_matrix.py).

Reference: doc/examples/swiss/* and doc/examples/examples.csv:5-13, the
de-facto acceptance suite of the reference: MALA/SMMALA with analytical
vs forward-mode vs reverse-mode gradients, plus RAM, HMC, NUTS, slice on
the 200x4 swiss banknote data.  The reference's forwarddiff/reversediff
variants run on autograd (``analytical_grad=False``, reverse mode, or
``ad_mode='forward'``); each runs as its own example so the matrix is
covered 1:1.  As in the JAX package, the swiss target's fused value and
gradient (kernel K1 on the card) serves ``logdensity_and_grad`` whatever
``analytical_grad`` says: autograd runs where a sampler asks for
``grad`` alone.

Every example ASSERTS its posterior mean against GOLD (a long 256-chain
NUTS run, see _gold()) within a tolerance scaled to the posterior sd, and
its acceptance rate against the sampler/tuner's expected band.  Each entry
of ``SWISS_EXAMPLES`` takes ``device`` and the run's sizes as keywords
(``n_chains``, ``n_steps``, ``burnin``), whose defaults are the
reference's, and returns its chain.
"""

import dataclasses

import numpy as np
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.models.examples import swiss_logistic_regression

# posterior mean/sd of the swiss logistic regression (prior N(0, 100 I)),
# computed by 64-chain x 2500-draw pooled-DA NUTS runs of the JAX package
# (examples/swiss_matrix.py --gold); two independent seeds agree to < 0.002
# on every coordinate
GOLD_MEAN = np.array([-0.7117, 0.7986, 0.9960, 3.0072])
GOLD_SD = np.array([0.2967, 0.4334, 0.4420, 0.4944])

X0 = (5.1, -0.9, 8.2, -4.5)  # reference init (swiss/MALA/analytical.jl)


def _gold(device=None):
    """Compute the gold-standard posterior moments (slow; the constants
    above come from the JAX package's run of the same settings)."""
    device = resolve_device(device)
    target, _, _ = swiss_logistic_regression(device=device)
    job = kt.MCJob(
        target,
        kt.NUTS(max_doublings=8),
        kt.MCRange(n_steps=6000, burnin=2000),
        tuner=kt.DualAveragingTuner(0.8, 2000),
        n_chains=256,
        pooled_tuning=True,
    )
    chain = job.run(torch.Generator(device).manual_seed(123), torch.tensor(X0, device=device))
    flat = chain.flat("value").cpu().numpy()
    return flat.mean(axis=0), flat.std(axis=0)


def _check(chain, name, rate_band=None, mean_tol_sds=0.35):
    flat = chain.flat("value").cpu().numpy()
    mean, sd = flat.mean(axis=0), flat.std(axis=0)
    err = np.abs(mean - GOLD_MEAN) / GOLD_SD
    rate = float(kt.stats.acceptance(chain))
    print(
        f"{name:34s} mean={np.round(mean, 3)} acc={rate:.3f} "
        f"max|err|/sd={err.max():.3f}"
    )
    assert err.max() < mean_tol_sds, (name, mean, GOLD_MEAN, err)
    np.testing.assert_allclose(sd, GOLD_SD, rtol=0.3, err_msg=name)
    if rate_band is not None:
        lo, hi = rate_band
        assert lo < rate < hi, (name, rate)
    return mean, rate


def _run(target, sampler, tuner, n_chains, mcrange, device, **kw):
    job = kt.MCJob(target, sampler, mcrange, tuner=tuner, n_chains=n_chains, **kw)
    return job.run(torch.Generator(device).manual_seed(7), torch.tensor(X0, device=device))


def _mk(sampler_fn, tuner_fn, rate_band, grad_kind, n_steps=6000, burnin=2000, **kw):
    """grad_kind: 'analytical' (hand-written gradient), 'reverse'
    (autograd's reverse mode: the reference's reversediff rows) or
    'forward' (Target(ad_mode='forward'), torch.func.jacfwd: the
    forwarddiff rows)."""
    default_steps, default_burnin = n_steps, burnin

    def example(n_chains=64, n_steps=default_steps, burnin=default_burnin, device=None):
        device = resolve_device(device)
        target, _, _ = swiss_logistic_regression(
            analytical_grad=grad_kind == "analytical", device=device
        )
        if grad_kind == "forward":
            target = dataclasses.replace(target, ad_mode="forward")
        mcrange = kt.MCRange(n_steps=n_steps, burnin=burnin)
        chain = _run(target, sampler_fn(), tuner_fn(burnin) if tuner_fn else None,
                     n_chains, mcrange, device, **kw)
        name = f"swiss {type(sampler_fn()).__name__} ({grad_kind})"
        _check(chain, name, rate_band)
        return chain

    return example


# the matrix: {MALA, SMMALA, RAM, HMC, NUTS, slice} x {analytical,
# reverse-AD}, plus the reference's forward-mode rows for MALA and SMMALA
# (doc/examples/swiss/MALA/forwarddiff.jl, swiss/SMMALA/forwarddiff.jl).
# Tuners/settings follow the reference scripts (e.g. swiss/MALA/
# analytical.jl uses AcceptanceRateMCTuner; swiss/SMMALA uses rate 0.5).
SWISS_EXAMPLES = {}
for kind in ("analytical", "reverse"):
    SWISS_EXAMPLES[f"swiss_mala_{kind}"] = _mk(
        lambda: kt.MALA(0.02),
        lambda b: kt.AcceptanceRateTuner(0.574),
        (0.40, 0.75),
        kind,
    )
    SWISS_EXAMPLES[f"swiss_smmala_{kind}"] = _mk(
        lambda: kt.SMMALA(0.02),
        lambda b: kt.AcceptanceRateTuner(0.5),
        (0.3, 0.85),
        kind,
    )
    SWISS_EXAMPLES[f"swiss_ram_{kind}"] = _mk(
        lambda: kt.RAM(S0=0.1), lambda b: None, (0.1, 0.5), kind
    )
    SWISS_EXAMPLES[f"swiss_hmc_{kind}"] = _mk(
        lambda: kt.HMC(0.1, 10),
        lambda b: kt.DualAveragingTuner(0.8, b),
        (0.6, 1.0),
        kind,
    )
    SWISS_EXAMPLES[f"swiss_nuts_{kind}"] = _mk(
        lambda: kt.NUTS(),
        lambda b: kt.DualAveragingTuner(0.8, b),
        (0.6, 1.0),
        kind,
    )
    SWISS_EXAMPLES[f"swiss_slice_{kind}"] = _mk(
        lambda: kt.SliceSampler(widths=1.0), lambda b: None, None, kind,
        n_steps=4000, burnin=1000,
    )
SWISS_EXAMPLES["swiss_mala_forward"] = _mk(
    lambda: kt.MALA(0.02),
    lambda b: kt.AcceptanceRateTuner(0.574),
    (0.40, 0.75),
    "forward",
)
SWISS_EXAMPLES["swiss_smmala_forward"] = _mk(
    lambda: kt.SMMALA(0.02),
    lambda b: kt.AcceptanceRateTuner(0.5),
    (0.3, 0.85),
    "forward",
)
SWISS_EXAMPLES["swiss_hmc_forward"] = _mk(
    lambda: kt.HMC(0.1, 10),
    lambda b: kt.DualAveragingTuner(0.8, b),
    (0.6, 1.0),
    "forward",
)
SWISS_EXAMPLES["swiss_nuts_forward"] = _mk(
    lambda: kt.NUTS(),
    lambda b: kt.DualAveragingTuner(0.8, b),
    (0.6, 1.0),
    "forward",
)
# no-adaptation rows: fixed step sizes from the reference scripts
# (swiss/HMC/noadaptation/*.jl: HMC(0.35); swiss/NUTS/noadaptation/*.jl:
# NUTS(0.4, maxndoublings=7)), VanillaMCTuner
for kind in ("analytical", "reverse"):
    SWISS_EXAMPLES[f"swiss_hmc_noadapt_{kind}"] = _mk(
        lambda: kt.HMC(0.35, 10), lambda b: None, (0.3, 0.95), kind,
        step_size=0.35,
    )
    SWISS_EXAMPLES[f"swiss_nuts_noadapt_{kind}"] = _mk(
        lambda: kt.NUTS(leapstep=0.4, max_doublings=7),
        lambda b: None,
        None,
        kind,
        n_steps=3000, burnin=1000, step_size=0.4,
    )
# per-coordinate adaptive Metropolis-within-Gibbs (swiss/AMWG.jl:
# MuvAMWG([2.5, 1., 3., 2.5]) + RobertsRosenthalMCTuner)
SWISS_EXAMPLES["swiss_amwg"] = _mk(
    lambda: kt.AMWG(sigma0=(2.5, 1.0, 3.0, 2.5)),
    lambda b: None,
    (0.2, 0.7),
    "reverse",
)


def _swiss_chees_precond(n_chains=64, n_steps=6000, burnin=2000, device=None):
    """Dense-preconditioned ChEES (MCJob.run_preconditioned) on the swiss
    posterior: the headline bench configuration asserted against the same
    gold moments as the rest of the matrix."""
    device = resolve_device(device)
    target, _, _ = swiss_logistic_regression(device=device)
    job = kt.MCJob(
        target,
        kt.HMC(leapstep=0.1, nleaps=4, trajectory_length=0.5,
               jitter=0.9, jitter_style="step", max_nleaps=128),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        tuner=kt.DualAveragingTuner(0.8, 2000),
        n_chains=n_chains,
        monitor=("value",),
        pooled_tuning=True,
        mass_adaptation=True,
        traj_adaptation=True,
    )
    chain, _, _ = job.run_preconditioned(
        torch.Generator(device).manual_seed(7), torch.tensor(X0, device=device),
        stage2_replace=dict(
            sampler=kt.HMC(leapstep=0.1, nleaps=4, trajectory_length=2.0,
                           jitter=0.9, jitter_style="step", max_nleaps=64),
            traj_adaptation=False,
        ),
    )
    _check(chain, "swiss_chees_precond", rate_band=(0.6, 0.95))
    return chain


SWISS_EXAMPLES["swiss_chees_precond"] = _swiss_chees_precond


def main(n_chains=64, device=None):
    for name, fn in SWISS_EXAMPLES.items():
        fn(n_chains, device=device)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "--gold":
        m, s = _gold()
        print("GOLD_MEAN =", repr(m))
        print("GOLD_SD   =", repr(s))
    else:
        main()
