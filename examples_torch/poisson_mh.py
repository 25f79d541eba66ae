"""Metropolis-Hastings over a discrete sample space, Poisson target
(counterpart of examples/poisson_mh.py).

Reference: doc/examples/Poisson/MH.jl: integer random walk with
Binary(i−1, i+1) proposals (Binary(0, 1) at the origin) and asymmetric
correction.  Positions are int32 and stay so in the trace.
"""

import math

import torch

import klara_tpu_torch as kt
from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.distributions import Binary


def main(lam=6.0, n_chains=64, n_steps=10000, burnin=1000, device=None):
    device = resolve_device(device)
    log_lam = math.log(lam)

    def logdensity(p):
        pf = p.to(torch.float32)
        lp = (pf * log_lam - torch.lgamma(pf + 1.0)).sum(-1)
        return torch.where((p >= 0).all(-1), lp, -torch.inf)

    def proposal(x, scale):
        at_zero = x == 0
        return Binary(torch.where(at_zero, 0, x - 1), torch.where(at_zero, 1, x + 1), 0.5)

    job = kt.MCJob(
        kt.Target(logdensity_fn=logdensity, dim=1),
        kt.MH(proposal_fn=proposal, symmetric=False),
        kt.MCRange(n_steps=n_steps, burnin=burnin),
        n_chains=n_chains,
    )
    chain = job.run(torch.Generator(device).manual_seed(0),
                    torch.tensor([2], dtype=torch.int32, device=device))
    draws = chain.flat("value").cpu().numpy()
    print("mean:", draws.mean(), "(target", lam, ")")
    print("acceptance:", float(kt.stats.acceptance(chain, diagnostics=False)))
    return chain


if __name__ == "__main__":
    main()
