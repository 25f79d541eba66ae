"""2-D unnormalised normal target across the MH-family sampler zoo
(counterpart of examples/normal_family.py).

Reference: README.md:23-70 (MH on the 2-D normal), README.md:153-198
(MALA + AcceptanceRateMCTuner(0.6)), README.md:206-264 (forward/reverse
AD variants), plus the AM/RAM/AMWG/slice/ARS variants exercised across
test/*.jl.  Posterior: N(0, I2); every example asserts mean ~ 0 and sd ~ 1.
Each entry of ``NORMAL_EXAMPLES`` takes ``device`` and the run's sizes as
keywords (``n_steps``, ``burnin``, ``n_chains``), whose defaults are the
reference's.
"""

import dataclasses
import math

import numpy as np
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device

X0 = (1.25, 3.11)


def _target(analytical=False):
    if analytical:
        return kt.Target(
            logdensity_fn=lambda x: -0.5 * (x * x).sum(-1),
            grad_fn=lambda x: -x,
            dim=2,
        )
    return kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2)


def _check(chain, name, rate_band=None):
    flat = chain.flat("value").cpu().numpy()
    mean, sd = flat.mean(axis=0), flat.std(axis=0)
    rate = float(kt.stats.acceptance(chain))
    print(f"{name:28s} mean={np.round(mean, 3)} sd={np.round(sd, 3)} acc={rate:.3f}")
    assert np.abs(mean).max() < 0.1, (name, mean)
    np.testing.assert_allclose(sd, 1.0, atol=0.12, err_msg=name)
    if rate_band is not None:
        assert rate_band[0] < rate < rate_band[1], (name, rate)


def _job(target, sampler, tuner=None, n_chains=32, n_steps=10000, burnin=1000,
         device=None, **kw):
    """Run ``target`` from the reference's start on ``device`` (seed 0)."""
    device = resolve_device(device)
    job = kt.MCJob(
        target,
        sampler,
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        tuner=tuner,
        n_chains=n_chains,
        **kw,
    )
    return job.run(torch.Generator(device).manual_seed(0), torch.tensor(X0, device=device))


def _run(sampler, tuner=None, analytical=False, **kw):
    return _job(_target(analytical), sampler, tuner, **kw)


def _run_forward(sampler, tuner=None, n_steps=5000, burnin=1000, **kw):
    """Forward-mode AD target (reference ForwardDiff rows)."""
    target = dataclasses.replace(_target(), ad_mode="forward")
    return _job(target, sampler, tuner, n_steps=n_steps, burnin=burnin, **kw)


def _run_pdf(sampler, n_steps=10000, burnin=1000, **kw):
    """Distribution-backed target: Target.from_distribution(Normal(0, 1))
    over a 2-vector, the reference's `pdf=...` parameter constructor
    (setpdf path, BasicContMuvParameter.jl:552-564)."""
    from klara_tpu_torch.distributions import Normal

    target = kt.Target.from_distribution(Normal(0.0, 1.0), dim=2)
    return _job(target, sampler, n_steps=n_steps, burnin=burnin, **kw)


def _steps(kw, n_steps):
    """The keywords of one example with its own default step count."""
    return {"n_steps": n_steps, **kw}


# each entry mirrors a reference README/test workload
NORMAL_EXAMPLES = {
    # README.md:23-70: vanilla MH, 10k steps / 1k burnin
    "normal_mh": lambda **kw: _check(_run(kt.MH(sigma=1.0), **kw), "normal MH", (0.2, 0.6)),
    # README.md:153-198: MALA tuned to 60% acceptance
    "normal_mala_tuned": lambda **kw: _check(
        _run(kt.MALA(0.9), kt.AcceptanceRateTuner(0.6), **kw),
        "normal MALA tuned(0.6)",
        (0.5, 0.7),
    ),
    # README.md:206-264: AD-gradient variants (autograd replaces both modes)
    "normal_mala_analytical": lambda **kw: _check(
        _run(kt.MALA(0.9), analytical=True, **kw), "normal MALA analytical"
    ),
    "normal_mala_ad": lambda **kw: _check(_run(kt.MALA(0.9), **kw), "normal MALA autograd"),
    # adaptive Metropolis family
    "normal_am": lambda **kw: _check(_run(kt.AM(), **kw), "normal AM"),
    "normal_ram": lambda **kw: _check(
        _run(kt.RAM(S0=1.0), **kw), "normal RAM", (0.1, 0.4)
    ),
    "normal_amwg": lambda **kw: _check(
        _run(kt.AMWG(sigma0=1.0), **kw), "normal AMWG", (0.3, 0.6)
    ),
    # slice sampler (always accepts)
    "normal_slice": lambda **kw: _check(
        _run(kt.SliceSampler(widths=2.0), **_steps(kw, 5000)), "normal slice"
    ),
    # HMC with dual averaging (fixed trajectory length, dynamic nleaps)
    "normal_hmc_da": lambda **kw: _check(
        _run(kt.HMC(0.2, 8), kt.DualAveragingTuner(0.8, 1000), **_steps(kw, 5000)),
        "normal HMC dual-avg",
        (0.6, 1.0),
    ),
    # NUTS: dual-averaging and no-adaptation variants (reference
    # Normal/NUTS/function/{dualaveraging,noadaptation}/*.jl)
    "normal_nuts_da": lambda **kw: _check(
        _run(kt.NUTS(), kt.DualAveragingTuner(0.8, 1000), **_steps(kw, 5000)),
        "normal NUTS dual-avg",
    ),
    "normal_nuts_noadapt": lambda **kw: _check(
        _run(kt.NUTS(leapstep=0.75), step_size=0.75, **_steps(kw, 5000)),
        "normal NUTS fixed-step",
    ),
    # HMC without adaptation (Normal/HMC/*/analytical.jl: HMC(0.75))
    "normal_hmc_noadapt": lambda **kw: _check(
        _run(kt.HMC(0.75, 10), step_size=0.75, **_steps(kw, 5000)),
        "normal HMC fixed-step",
        (0.5, 1.0),
    ),
    # HMC with forward-mode AD (Normal/HMC/function/forwarddiff.jl)
    "normal_hmc_forward": lambda **kw: _check(
        _run_forward(kt.HMC(0.2, 8), kt.DualAveragingTuner(0.8, 1000), **kw),
        "normal HMC forward-AD",
        (0.6, 1.0),
    ),
    # distribution-backed targets (reference's pdf-ctor rows,
    # Normal/AM/pdf.jl and Normal/MALA/pdf/*.jl): the target is
    # Target.from_distribution(Normal(0, 1)) instead of a log-density fn
    "normal_am_pdf": lambda **kw: _check(_run_pdf(kt.AM(), **kw), "normal AM (pdf)"),
    "normal_mala_pdf": lambda **kw: _check(
        _run_pdf(kt.MALA(0.9), **kw), "normal MALA (pdf)"
    ),
    # acceptance-rejection with a wide normal envelope: the reference's
    # test/ARS.jl:1-40 config verbatim: target N(0,1) shape, envelope
    # N(0,2), proposalscale=log(10).  Like the reference kernel
    # (iterate/ARS.jl:6-14), rejected moves keep the last value, so the
    # chain is over-dispersed relative to the target: the example asserts
    # the kernel's actual behaviour (centred, sd between target and
    # envelope), not an exactness the reference never had.
    "normal_ars": lambda **kw: _ars_example(**kw),
}


def _ars_example(**kw):
    log_norm = math.log(2.0 * math.sqrt(2.0 * math.pi))
    chain = _run(
        kt.ARS(
            logproposal=lambda x: -(x * x).sum(-1) / 8.0 - log_norm,
            proposalscale=math.log(10.0),
            jumpscale=1.0,
        ),
        **kw,
    )
    flat = chain.flat("value").cpu().numpy()
    mean, sd = flat.mean(axis=0), flat.std(axis=0)
    rate = float(kt.stats.acceptance(chain))
    print(f"{'normal ARS':28s} mean={np.round(mean, 3)} sd={np.round(sd, 3)} acc={rate:.3f}")
    assert np.abs(mean).max() < 0.15
    assert np.all(sd > 0.9) and np.all(sd < 2.1)
    assert 0.01 < rate < 0.5  # M=10 envelope scale makes acceptance rare


def main(n_chains=32, device=None):
    for fn in NORMAL_EXAMPLES.values():
        fn(n_chains=n_chains, device=device)


if __name__ == "__main__":
    main()
