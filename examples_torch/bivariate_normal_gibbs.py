"""Gibbs sampling of a bivariate normal, ρ = 0.8 (counterpart of
examples/bivariate_normal_gibbs.py).

Reference: doc/examples/BivariateNormal/Gibbs.jl:1-37: full-conditional
draws p1 | p2 ~ N(ρ·p2, 1−ρ²); check cor(p1, p2) ≈ ρ.  The conditionals
see the carried p1 and p2 per chain, (C,).
"""

import numpy as np
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.distributions import Normal


def main(n_chains=256, n_steps=10000, burnin=1000, device=None):
    device = resolve_device(device)
    rho = 0.8
    p1 = kt.GibbsParameter(
        "p1", setpdf=lambda v: Normal(v["rho"] * v["p2"], torch.sqrt(1 - v["rho"] ** 2))
    )
    p2 = kt.GibbsParameter(
        "p2", setpdf=lambda v: Normal(v["rho"] * v["p1"], torch.sqrt(1 - v["rho"] ** 2))
    )
    model = kt.GenericModel([kt.Hyperparameter("rho"), p1, p2])
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=n_steps, burnin=burnin),
                      n_chains=n_chains, device=device)
    chains = job.run(torch.Generator(device).manual_seed(0),
                     {"rho": torch.tensor(rho, device=device), "p1": 5.1, "p2": 2.3})

    x1, x2 = chains.flat("p1").cpu().numpy(), chains.flat("p2").cpu().numpy()
    print("means:", x1.mean(), x2.mean())
    print("cor(p1,p2):", np.corrcoef(x1, x2)[0, 1])
    return chains


if __name__ == "__main__":
    main()
