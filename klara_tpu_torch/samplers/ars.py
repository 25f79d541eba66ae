"""Acceptance-rejection sampler with random-walk jumps, batch-first
(counterpart of klara_tpu/samplers/ars.py):

    x' = x + jumpscale·z,  z ~ N(0, I)
    weight = logπ(x') − proposalscale − logproposal(x')
    accept iff weight > log(rand())

``logproposal`` maps (C, ...) positions to the (C,) unnormalised log-envelope,
with logπ ≤ proposalscale + logproposal on the support.  The jump is accepted
against the envelope with no Metropolis correction, as in Klara, so the draws
lie between target and envelope.  The ``weight`` diagnostic is the rejection
weight.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

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


class ARSState(NamedTuple):
    position: torch.Tensor   # (C, ...)
    logtarget: torch.Tensor  # (C,)
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class ARS(Sampler):
    logproposal: Callable = None   # envelope log-density, (C, ...) -> (C,)
    proposalscale: float = 1.0
    jumpscale: float = 1.0

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        step0 = per_chain_step(self.jumpscale, position.shape[0], position.dtype,
                               position.device)
        tune = (tuner or self.default_tuner()).init(step0)
        return ARSState(position, target.logdensity(position), tune)

    def step(self, state: ARSState, target, generator=None, z=None, u=None, stream=None):
        """One jump for every chain; ``z`` and ``u`` may be given to replay
        draws."""
        x, lt = state.position, state.logtarget
        if z is None or u is None:
            stream = step_stream(stream, generator, x)
        if z is None:
            z = draw_normal(stream, PROPOSAL, x)
        x_new = x + chain_view(state.tune.step, x) * z
        lt_new = target.logdensity(x_new)
        weight = lt_new - self.proposalscale - self.logproposal(x_new)
        accept = metropolis_accept(weight, stream, u)
        position = torch.where(chain_view(accept, x), x_new, x)
        logtarget = torch.where(accept, lt_new, lt)
        info = Info(accept=accept, accept_stat=accept_prob(weight), logtarget=logtarget,
                    extras={"weight": weight})
        return ARSState(position, logtarget, state.tune), info
