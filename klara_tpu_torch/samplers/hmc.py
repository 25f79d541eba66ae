"""Hamiltonian Monte Carlo, batch-first (counterpart of klara_tpu/samplers/hmc.py).

With a dual-averaging tuner the trajectory length λ is held fixed and the
per-chain leap count is recomputed every step as
nleaps = clip(round(λ·frac/ε), 1, max_nleaps); ``torch.round`` rounds half
to even like ``jnp.round``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from klara_tpu_torch.ops.keyed import JITTER
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    chain_view,
    draw_uniform,
    metropolis_accept,
    step_stream,
)
from klara_tpu_torch.samplers.hamiltonian import (
    PhasePoint,
    hamiltonian,
    init_tune,
    leapfrog,
    sample_momentum,
)
from klara_tpu_torch.tuners.tuners import DualAveragingTuner, TuneState


def jitter_fraction(u, jitter: float):
    """Map U(0, 1) draws to U(1-jitter, 1+jitter) with the JAX package's
    arithmetic for a uniform in [lo, hi): u·(hi−lo) + lo, floored at lo.
    The bounds are 0-d fills on ``u``'s device: a copy from host memory
    would make the host wait for the device at every step."""
    lo, hi = (torch.full((), 1.0 + s * jitter, dtype=u.dtype, device=u.device) for s in (-1, 1))
    return torch.maximum(lo, u * (hi - lo) + lo)


class HMCState(NamedTuple):
    position: torch.Tensor       # (C, D)
    logtarget: torch.Tensor      # (C,)
    gradlogtarget: torch.Tensor  # (C, D)
    inv_mass: torch.Tensor       # (C, D) diagonal inverse mass (1 = identity)
    tune: TuneState
    # log trajectory length λ and its Adam moments, (C,) each, adapted
    # across chains by the job's ChEES hook
    log_traj: torch.Tensor
    traj_m: torch.Tensor
    traj_v: torch.Tensor


@dataclasses.dataclass(frozen=True)
class HMC(Sampler):
    leapstep: float = 0.1
    nleaps: int = 10
    # fixed trajectory length used with dual averaging; None -> nleaps*leapstep
    trajectory_length: float | None = None
    # cap on the per-iteration leapfrog count when nleaps is dynamic
    max_nleaps: int = 1024
    # recompute nleaps = round(λ/ε) per step; set by bind_tuner under dual averaging
    dynamic_nleaps: bool = False
    # multiply λ by U(1-jitter, 1+jitter) each step (dynamic nleaps only)
    jitter: float = 0.0
    # 'step': one shared draw per iteration, applied by the job to every
    # chain (all chains run the same leap count); 'chain': per-chain draws
    # inside step(), run to the batch maximum
    jitter_style: str = "step"

    tuner_statistic = "accept_stat"

    def bind_tuner(self, tuner):
        if isinstance(tuner, DualAveragingTuner) and not self.dynamic_nleaps:
            return dataclasses.replace(self, dynamic_nleaps=True)
        return self

    def _lambda0(self):
        lam = self.trajectory_length
        return self.nleaps * self.leapstep if lam is None else lam

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             momentum=None, stream=None):
        """``momentum`` feeds the step-size search (tests replay draws)."""
        lt, grad = target.logdensity_and_grad(position)
        tune = init_tune(tuner or self.default_tuner(), target, position, self.leapstep,
                         generator, step_size, momentum, stream)
        C = position.shape[0]
        kw = dict(dtype=position.dtype, device=position.device)
        return HMCState(
            position, lt, grad, torch.ones_like(position), tune,
            log_traj=torch.log(torch.full((C,), float(self._lambda0()), **kw)),
            traj_m=torch.zeros(C, **kw),
            traj_v=torch.zeros(C, **kw),
        )

    def _nleaps(self, eps, log_traj, stream=None, jitter_u=None):
        """Per-chain leap counts (C,) int32 and the realised jitter fraction."""
        ones = torch.ones_like(eps)
        if not self.dynamic_nleaps:
            return torch.full(eps.shape, self.nleaps, dtype=torch.int32, device=eps.device), ones
        lam = torch.exp(log_traj)
        frac = ones
        if self.jitter > 0.0:
            u = jitter_u if jitter_u is not None else draw_uniform(stream, JITTER, eps.shape, eps)
            frac = jitter_fraction(u, self.jitter)
            lam = lam * frac
        n = torch.round(lam / eps).to(torch.int32)
        return torch.clamp(n, 1, self.max_nleaps), frac

    def step(self, state: HMCState, target, generator=None, momentum=None, u=None,
             jitter_u=None, stream=None):
        """One HMC transition for every chain.  ``momentum``, ``u`` (the
        accept uniform) and ``jitter_u`` may be given to replay draws."""
        jittered = self.dynamic_nleaps and self.jitter > 0.0
        if momentum is None or u is None or (jittered and jitter_u is None):
            stream = step_stream(stream, generator, state.position)
        start, h0, nleaps, frac = self.begin(state, stream, momentum, jitter_u)
        pp = leapfrog(target, start, state.tune.step, nleaps, state.inv_mass)
        return self.finish(state, pp, h0, nleaps, frac, stream, u)

    def begin(self, state: HMCState, stream, momentum=None, jitter_u=None):
        """A transition's start: (the phase point with its momentum drawn,
        H there, the per-chain leap counts, the jitter fraction)."""
        x, lt, grad = state.position, state.logtarget, state.gradlogtarget
        nleaps, frac = self._nleaps(state.tune.step, state.log_traj, stream, jitter_u)
        p0 = momentum if momentum is not None else sample_momentum(stream, x, state.inv_mass)
        h0 = hamiltonian(lt, p0, state.inv_mass)
        return PhasePoint(x, p0, lt, grad), h0, nleaps, frac

    def finish(self, state: HMCState, pp: PhasePoint, h0, nleaps, frac, stream, u=None):
        """A transition's end from the trajectory's last point ``pp``: the
        Metropolis test against H ``h0`` at its start; (new state, info)."""
        x, lt, grad = state.position, state.logtarget, state.gradlogtarget
        h1 = hamiltonian(pp.logtarget, pp.momentum, state.inv_mass)
        ratio = h1 - h0
        ratio = torch.where(torch.isnan(ratio), torch.full_like(ratio, -math.inf), ratio)

        accept = metropolis_accept(ratio, stream, u)
        acc = chain_view(accept, x)
        new_state = state._replace(
            position=torch.where(acc, pp.position, x),
            logtarget=torch.where(accept, pp.logtarget, lt),
            gradlogtarget=torch.where(acc, pp.gradlogtarget, grad),
        )
        a = torch.exp(torch.clamp_max(ratio, 0.0))
        info = Info(
            accept=accept,
            accept_stat=a,
            logtarget=new_state.logtarget,
            extras={
                "nleaps": nleaps,
                # phase-space endpoints for the job's cross-chain ChEES hook
                "x_prop": pp.position,
                "p_end": pp.momentum,
                "traj_frac": frac,
            },
        )
        return new_state, info
