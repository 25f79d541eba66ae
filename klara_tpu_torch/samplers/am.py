"""Adaptive Metropolis (Haario et al. 2001, in Roberts and Rosenthal's mixture
form), batch-first (counterpart of klara_tpu/samplers/am.py).

  * the first ``t0`` steps propose from N(x, minorscale·I);
  * afterwards the chain's empirical covariance C is updated recursively and
    the proposal is the mixture
    (1−c)·N(x, corescale·C) + c·N(x, minorscale·I);
  * the running mean is tracked recursively.

Every chain adapts its own covariance: the state holds C as (C, D, D), and a
step factors all of them in one batched Cholesky.  Both proposal branches
are computed and selected per chain, so the step reads nothing back from the
device.  Within one step the forward and reverse proposals share their
covariance, so the mixture's correction to the ratio is exactly zero and is
not evaluated.  Self-tuning: the job's tuner is bypassed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from klara_tpu_torch.ops.keyed import AM_COMPONENT, PROPOSAL
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    accept_prob,
    cholesky_or_nan,
    draw_normal,
    draw_uniform,
    metropolis_accept,
    per_chain_step,
    scale_matrix,
    step_stream,
)
from klara_tpu_torch.stats.covariance import recursive_covariance
from klara_tpu_torch.stats.mean import recursive_mean
from klara_tpu_torch.tuners.tuners import TuneState


class AMState(NamedTuple):
    position: torch.Tensor        # (C, D)
    logtarget: torch.Tensor       # (C,)
    C: torch.Tensor               # (C, D, D) running empirical covariance
    lastmean: torch.Tensor        # (C, D)
    secondlastmean: torch.Tensor  # (C, D)
    count: torch.Tensor           # (C,) int32, the same in every chain
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class AM(Sampler):
    C0: Optional[object] = None  # initial covariance (scalar/vector/matrix); None: I
    corescale: float = 1.0
    minorscale: float = 1.0
    c: float = 0.05
    t0: int = 10

    self_tuning = True

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        C = position.shape[0]
        tune = (tuner or self.default_tuner()).init(
            per_chain_step(1.0, C, position.dtype, position.device))
        return AMState(
            position=position,
            logtarget=target.logdensity(position),
            C=scale_matrix(self.C0, position),
            lastmean=position,
            secondlastmean=position,
            count=torch.zeros(C, dtype=torch.int32, device=position.device),
            tune=tune,
        )

    def step(self, state: AMState, target, generator=None, z=None, u=None, u_comp=None,
             stream=None):
        """One transition for every chain.  ``z`` (the proposal's standard
        normal draw), ``u`` (the accept uniform) and ``u_comp`` (the mixture
        component's uniform) may be given to replay draws."""
        x, lt = state.position, state.logtarget
        d = x.shape[-1]
        count = state.count + 1
        adapting = count > self.t0

        cov = torch.where(
            adapting[:, None, None],
            recursive_covariance(
                state.C, torch.clamp_min(count - 2, 1), x, state.lastmean,
                state.secondlastmean,
            ),
            state.C,
        )
        cov = 0.5 * (cov + cov.mT)  # Hermitian-ise

        if u_comp is None or z is None or u is None:
            stream = step_stream(stream, generator, x)
        if u_comp is None:
            u_comp = draw_uniform(stream, AM_COMPONENT, x.shape[:1], x)
        if z is None:
            z = draw_normal(stream, PROPOSAL, x)
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        core_chol = cholesky_or_nan(self.corescale * cov + 1e-10 * eye)
        use_minor = u_comp < self.c
        step_core = (core_chol @ z[..., None])[..., 0]
        step_minor = math.sqrt(self.minorscale) * z
        x_new = x + torch.where((adapting & ~use_minor)[:, None], step_core, step_minor)

        lt_new = target.logdensity(x_new)
        ratio = lt_new - lt
        accept = metropolis_accept(ratio, stream, u)
        position = torch.where(accept[:, None], x_new, x)
        logtarget = torch.where(accept, lt_new, lt)

        lastmean = recursive_mean(state.lastmean, count.to(x.dtype)[:, None], position)
        new_state = AMState(position, logtarget, cov, lastmean, state.lastmean, count,
                            state.tune)
        return new_state, Info(accept=accept, accept_stat=accept_prob(ratio),
                               logtarget=logtarget)
