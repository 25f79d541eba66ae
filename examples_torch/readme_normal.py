"""README workflow: 2-D unnormalised normal with MH, MALA(+tuner), and AD
(counterpart of examples/readme_normal.py).

Reference: README.md:23-264, the canonical first-contact examples:
  * MH, 10k steps / 1k burnin, mean(chain) ~ 0;
  * MALA with AcceptanceRateTuner(0.6);
  * MALA with AD gradients (autograd replaces Forward/ReverseDiff: omit
    grad_fn and the Target differentiates itself).
"""

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device


def main(n_chains=64, verbose=False, n_steps=10000, burnin=1000, device=None):
    device = resolve_device(device)
    # p(x) ∝ exp(-½ xᵀx), mean checked against 0
    target = kt.Target(logdensity_fn=lambda x: -0.5 * torch.square(x).sum(-1), dim=2)
    mcrange = kt.MCRange(n_steps=n_steps, burnin=burnin)
    v0 = torch.tensor([1.25, 3.11], device=device)

    job = kt.MCJob(target, kt.MH(sigma=1.0), mcrange, n_chains=n_chains, verbose=verbose)
    chain = job.run(torch.Generator(device).manual_seed(0), v0)
    print("MH    mean:", kt.stats.mean(chain), "acceptance:", kt.stats.acceptance(chain))

    # MALA + acceptance-rate tuning toward 60%
    job = kt.MCJob(
        target,
        kt.MALA(driftstep=0.5),
        mcrange,
        tuner=kt.AcceptanceRateTuner(0.6),
        n_chains=n_chains,
        verbose=verbose,
    )
    chain = job.run(torch.Generator(device).manual_seed(1), v0)
    print("MALA  mean:", kt.stats.mean(chain), "acceptance:", kt.stats.acceptance(chain))

    # analytical gradient variant (reference README.md:76-120)
    target_analytic = kt.Target(
        logdensity_fn=lambda x: -0.5 * torch.square(x).sum(-1),
        grad_fn=lambda x: -x,
        dim=2,
    )
    job = kt.MCJob(target_analytic, kt.MALA(0.9), mcrange, n_chains=n_chains)
    chain = job.run(torch.Generator(device).manual_seed(2), v0)
    print("MALA* mean:", kt.stats.mean(chain), "ess:", kt.stats.ess(chain))
    return chain


if __name__ == "__main__":
    main()
