"""Correlated bivariate normal across the sampler zoo (counterpart of
examples/bivariate_family.py).

Reference: doc/examples/BivariateNormal/{AM,AMWG,MALA,SMMALA}/*.jl: the
target is N(0, Σ) with Σ = [[1, ρ], [ρ, 1]], ρ = 0.8, specified either as
a log-density function ('function' rows) or as a distribution object
('pdf' rows, the setpdf constructor path); MALA/SMMALA rows run with
analytical vs autograd derivatives (reverse mode, or forward mode through
``torch.func.jacfwd``).  Every example asserts the posterior mean,
marginal sds, and the correlation ρ.  Each entry of ``BIVARIATE_EXAMPLES``
takes ``device`` and the run's sizes as keywords, whose defaults are the
reference's.
"""

import dataclasses

import numpy as np
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.distributions import MvNormal

RHO = 0.8


def _cov(device):
    return torch.tensor([[1.0, RHO], [RHO, 1.0]], device=device)


def _target(kind="function", grad="ad", device=None):
    cov = _cov(device)
    if kind == "pdf":
        return kt.Target.from_distribution(
            MvNormal.from_cov(torch.zeros(2, device=device), cov), dim=2
        )
    prec = torch.linalg.inv(cov)
    # row-wise quadratic form xᵀ Σ⁻¹ x of a (C, 2) batch
    t = kt.Target(
        logdensity_fn=lambda x: -0.5 * ((x @ prec) * x).sum(-1),
        dim=2,
    )
    if grad == "analytical":
        t = dataclasses.replace(t, grad_fn=lambda x: -(x @ prec))
    elif grad == "forward":
        t = dataclasses.replace(t, ad_mode="forward")
    return t


def _check(chain, name):
    flat = chain.flat("value").cpu().numpy()
    mean, sd = flat.mean(axis=0), flat.std(axis=0)
    corr = float(np.corrcoef(flat.T)[0, 1])
    rate = float(kt.stats.acceptance(chain))
    print(f"{name:30s} mean={np.round(mean, 3)} sd={np.round(sd, 3)} "
          f"corr={corr:.3f} acc={rate:.3f}")
    assert np.abs(mean).max() < 0.12, (name, mean)
    np.testing.assert_allclose(sd, 1.0, atol=0.15, err_msg=name)
    np.testing.assert_allclose(corr, RHO, atol=0.05, err_msg=name)


def _run(sampler, kind="function", grad="ad", tuner=None, n_steps=10000,
         burnin=1000, n_chains=32, device=None, **kw):
    device = resolve_device(device)
    job = kt.MCJob(
        _target(kind, grad, device), sampler, kt.MCRange(n_steps=n_steps, burnin=burnin),
        tuner=tuner, n_chains=n_chains, **kw,
    )
    return job.run(torch.Generator(device).manual_seed(0),
                   torch.tensor([1.1, -0.7], device=device))


BIVARIATE_EXAMPLES = {
    # AM: function and pdf target flavours (BivariateNormal/AM/*.jl)
    "biv_am_function": lambda **kw: _check(_run(kt.AM(), **kw), "bivariate AM (function)"),
    "biv_am_pdf": lambda **kw: _check(
        _run(kt.AM(), kind="pdf", **kw), "bivariate AM (pdf)"
    ),
    # AMWG on a correlated target (BivariateNormal/AMWG/function.jl)
    "biv_amwg": lambda **kw: _check(
        _run(kt.AMWG(sigma0=1.0), **{"n_steps": 12000, **kw}), "bivariate AMWG"
    ),
    # MALA x {analytical, reverse, forward} x {function, pdf}
    "biv_mala_analytical": lambda **kw: _check(
        _run(kt.MALA(0.5), grad="analytical", **kw), "bivariate MALA analytical"
    ),
    "biv_mala_reverse": lambda **kw: _check(
        _run(kt.MALA(0.5), **kw), "bivariate MALA autograd"
    ),
    "biv_mala_forward": lambda **kw: _check(
        _run(kt.MALA(0.5), grad="forward", **kw), "bivariate MALA forward-AD"
    ),
    "biv_mala_pdf": lambda **kw: _check(
        _run(kt.MALA(0.5), kind="pdf", **kw), "bivariate MALA (pdf)"
    ),
    # SMMALA x {analytical, AD} (BivariateNormal/SMMALA/*.jl)
    "biv_smmala_analytical": lambda **kw: _check(
        _run(
            kt.SMMALA(1.0),
            grad="analytical",
            tuner=kt.AcceptanceRateTuner(0.7),
            **kw,
        ),
        "bivariate SMMALA analytical",
    ),
    "biv_smmala_ad": lambda **kw: _check(
        _run(kt.SMMALA(1.0), tuner=kt.AcceptanceRateTuner(0.7), **kw),
        "bivariate SMMALA autograd Hessian",
    ),
}


def main(n_chains=32, device=None):
    for fn in BIVARIATE_EXAMPLES.values():
        fn(n_chains=n_chains, device=device)


if __name__ == "__main__":
    main()
