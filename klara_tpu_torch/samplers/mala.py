"""Metropolis-adjusted Langevin algorithm, batch-first (counterpart of
klara_tpu/samplers/mala.py):

    μ  = x  + (ε/2)·∇logπ(x);   x' = μ + √ε·z
    μ' = x' + (ε/2)·∇logπ(x')
    ratio = logπ(x') − logπ(x) + logN(x | μ', ε·I) − logN(x' | μ, ε·I)

The drift step ε is the per-chain ``tune.step``, so the step tuners adapt
it.  Each step costs one ``logdensity_and_grad`` of the batch (one launch of
the fused kernel on the logreg targets).  The ratio keeps the JAX package's
order of operations, so replayed draws give the same accept decisions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from klara_tpu_torch.models.graph import chain_sum
from klara_tpu_torch.ops.keyed import PROPOSAL
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    accept_prob,
    chain_view,
    draw_normal,
    metropolis_accept,
    per_chain_step,
    step_stream,
)
from klara_tpu_torch.tuners.tuners import TuneState


class MALAState(NamedTuple):
    position: torch.Tensor       # (C, ...)
    logtarget: torch.Tensor      # (C,)
    gradlogtarget: torch.Tensor  # (C, ...)
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class MALA(Sampler):
    driftstep: float = 1.0

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        lt, grad = target.logdensity_and_grad(position)
        step0 = per_chain_step(self.driftstep if step_size is None else step_size,
                               position.shape[0], position.dtype, position.device)
        return MALAState(position, lt, grad, (tuner or self.default_tuner()).init(step0))

    def step(self, state: MALAState, target, generator=None, z=None, u=None, stream=None):
        """One MALA transition for every chain.  ``z`` (the proposal's
        standard normal draw) and ``u`` (the accept uniform) may be given to
        replay draws."""
        x, lt, grad = state.position, state.logtarget, state.gradlogtarget
        eps_c = state.tune.step
        eps = chain_view(eps_c, x)
        if z is None or u is None:
            stream = step_stream(stream, generator, x)
        if z is None:
            z = draw_normal(stream, PROPOSAL, x)

        mu = x + 0.5 * eps * grad
        x_new = mu + torch.sqrt(eps) * z
        lt_new, grad_new = target.logdensity_and_grad(x_new)
        mu_rev = x_new + 0.5 * eps * grad_new

        def lognorm(v, m):  # logN(v | m, ε I) up to the shared constant
            return -chain_sum(torch.square(v - m)) / (2.0 * eps_c)

        ratio = lt_new - lt + lognorm(x, mu_rev) - lognorm(x_new, mu)
        accept = metropolis_accept(ratio, stream, u)
        acc = chain_view(accept, x)
        logtarget = torch.where(accept, lt_new, lt)
        new_state = MALAState(
            position=torch.where(acc, x_new, x),
            logtarget=logtarget,
            gradlogtarget=torch.where(acc, grad_new, grad),
            tune=state.tune,
        )
        return new_state, Info(accept=accept, accept_stat=accept_prob(ratio),
                               logtarget=logtarget)
