"""BUGS rats hierarchical normal model, conjugate Gibbs (counterpart of
examples/rats_gibbs.py).

Reference: doc/examples/rats/Gibbs.jl (left as a TODO in the reference,
completed here).  Published BUGS posterior: alpha_c ≈ 242.5, beta_c ≈ 6.19.
"""

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.models.examples import rats_gibbs_model


def main(n_chains=64, n_steps=5000, burnin=1000, device=None):
    device = resolve_device(device)
    model, v0 = rats_gibbs_model(device=device)
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=n_steps, burnin=burnin),
                      n_chains=n_chains, device=device)
    chains = job.run(torch.Generator(device).manual_seed(0), v0)
    for k in ("alpha_c", "beta_c", "sigma2_c"):
        print(f"{k}: {float(chains.flat(k).mean()):.3f}")
    return chains


if __name__ == "__main__":
    main()
