"""MH when target and proposal have differing support, Gamma target
(counterpart of examples/gamma_mh.py).

Reference: doc/examples/Gamma/MH.jl + MALA.jl: unnormalised Gamma(shape,
rate) log-target on x > 0, sampled with a log-normal random-walk proposal
(asymmetric, corrected).  The support check is per chain.
"""

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.distributions import LogNormal


def main(shape=3.0, rate=2.0, n_chains=64, n_steps=10000, burnin=1000, device=None):
    device = resolve_device(device)

    def logdensity(x):
        ld = ((shape - 1.0) * torch.log(x) - rate * x).sum(-1)
        return torch.where((x > 0).all(-1), ld, -torch.inf)

    target = kt.Target(logdensity_fn=logdensity, dim=1)

    # multiplicative log-normal walk: supports stay positive; the tuned
    # scale s is per chain, (C,)
    job = kt.MCJob(
        target,
        kt.MH(proposal_fn=lambda x, s: LogNormal(torch.log(x), 0.5 * s[:, None]),
              symmetric=False),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        n_chains=n_chains,
    )
    chain = job.run(torch.Generator(device).manual_seed(0), torch.tensor([1.0], device=device))
    draws = chain.flat("value").cpu().numpy()
    print("mean:", draws.mean(), "(target", shape / rate, ")")
    print("var:", draws.var(), "(target", shape / rate**2, ")")
    return chain


if __name__ == "__main__":
    main()
