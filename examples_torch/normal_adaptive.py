"""Adaptive samplers on normal targets: AM, AMWG, HMC, NUTS, slice
(counterpart of examples/normal_adaptive.py).

Reference: doc/examples/Normal/{AM,AMWG,HMC,NUTS,SliceSampler}.
"""

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device


def main(n_chains=64, n_steps=6000, burnin=2000, device=None):
    device = resolve_device(device)
    target = kt.Target(logdensity_fn=lambda x: -0.5 * torch.square(x).sum(-1), dim=3)
    mcrange = kt.MCRange(n_steps=n_steps, burnin=burnin)
    x0 = torch.full((3,), 2.0, device=device)

    for name, sampler, tuner in [
        ("AM   ", kt.AM(corescale=2.88 / 3), None),
        ("AMWG ", kt.AMWG(sigma0=1.0), None),
        ("HMC  ", kt.HMC(0.1, 10), kt.DualAveragingTuner(0.8, 2000)),
        ("NUTS ", kt.NUTS(), kt.DualAveragingTuner(0.8, 2000)),
        ("Slice", kt.SliceSampler(widths=2.0), None),
    ]:
        job = kt.MCJob(target, sampler, mcrange, tuner=tuner, n_chains=n_chains)
        chain = job.run(torch.Generator(device).manual_seed(0), x0)
        print(
            f"{name} mean={kt.stats.mean(chain)} ess={kt.stats.ess(chain)} "
            f"rhat={kt.stats.rhat(chain)}"
        )


if __name__ == "__main__":
    main()
