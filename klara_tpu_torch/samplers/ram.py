"""Robust Adaptive Metropolis (Vihola 2012), batch-first (counterpart of
klara_tpu/samplers/ram.py):

    x' = x + S·z,  z ~ N(0, I)
    η  = min(1, d·count^{-γ})
    SSᵀ ← S (I + η·(min(1, e^ratio) − targetrate)·zzᵀ/‖z‖²) Sᵀ
    S  ← chol(SSᵀ)

Every chain adapts its own factor: the state holds S as (C, D, D), and the
update is two batched products around the rank-1 term and one batched
Cholesky.  A chain whose update is not positive definite keeps its factor.
The adaptation runs at every step, after burnin too.  Self-tuning.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from klara_tpu_torch.ops.keyed import PROPOSAL
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    accept_prob,
    cholesky_or_nan,
    draw_normal,
    metropolis_accept,
    per_chain_step,
    scale_matrix,
    step_stream,
)
from klara_tpu_torch.tuners.tuners import TuneState


class RAMState(NamedTuple):
    position: torch.Tensor   # (C, D)
    logtarget: torch.Tensor  # (C,)
    S: torch.Tensor          # (C, D, D) lower-triangular proposal factor
    count: torch.Tensor      # (C,) int32
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class RAM(Sampler):
    S0: Optional[object] = None  # initial factor (scalar/vector/matrix); None: I
    targetrate: float = 0.234
    gamma: float = 0.7

    self_tuning = True

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        C = position.shape[0]
        tune = (tuner or self.default_tuner()).init(
            per_chain_step(1.0, C, position.dtype, position.device))
        return RAMState(
            position,
            target.logdensity(position),
            torch.tril(scale_matrix(self.S0, position)),
            torch.zeros(C, dtype=torch.int32, device=position.device),
            tune,
        )

    def step(self, state: RAMState, target, generator=None, z=None, u=None, stream=None):
        """One transition for every chain; ``z`` and ``u`` may be given to
        replay draws."""
        x, lt, S = state.position, state.logtarget, state.S
        f, d = x.dtype, x.shape[-1]
        count = state.count + 1
        if z is None or u is None:
            stream = step_stream(stream, generator, x)
        if z is None:
            z = draw_normal(stream, PROPOSAL, x)

        x_new = x + (S @ z[..., None])[..., 0]
        lt_new = target.logdensity(x_new)
        ratio = lt_new - lt
        accept = metropolis_accept(ratio, stream, u)
        position = torch.where(accept[:, None], x_new, x)
        logtarget = torch.where(accept, lt_new, lt)

        # rank-1 adaptation of the factor
        alpha = accept_prob(ratio)
        alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
        eta = torch.clamp_max(d * count.to(f) ** (-self.gamma), 1.0)
        zz = (z[:, :, None] * z[:, None, :]) / torch.clamp_min(
            torch.square(z).sum(-1), 1e-20)[:, None, None]
        eye = torch.eye(d, dtype=f, device=x.device)
        sst = S @ (eye + (eta * (alpha - self.targetrate))[:, None, None] * zz) @ S.mT
        sst = 0.5 * (sst + sst.mT) + 1e-12 * eye
        S_new = cholesky_or_nan(sst)
        failed = torch.isnan(S_new).flatten(1).any(-1)
        S_new = torch.where(failed[:, None, None], S, S_new)

        new_state = RAMState(position, logtarget, S_new, count, state.tune)
        return new_state, Info(accept=accept, accept_stat=alpha, logtarget=logtarget)
