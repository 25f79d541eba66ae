"""Hamiltonian-dynamics utilities, batch-first (counterpart of
klara_tpu/samplers/hamiltonian.py).

Per-chain control flow is masked, not looped per chain: ``leapfrog`` takes a
per-chain step count, runs to the batch maximum and freezes finished chains
with ``torch.where``; the step-size search keeps a per-chain ε and "active"
flag and evaluates the target on the whole batch each iteration.  A per-chain
position may have any rank: (C,) scalars, (C, D) vectors, (C, A, B) matrices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from klara_tpu_torch.models.graph import chain_sum
from klara_tpu_torch.ops.keyed import INIT_MOMENTUM, MOMENTUM
from klara_tpu_torch.samplers.base import chain_view, draw_normal, per_chain_step, step_stream
from klara_tpu_torch.tuners.tuners import DualAveragingTuner
from klara_tpu_torch.utils import tracing


def hamiltonian(logtarget, momentum, inv_mass=None):
    """H(x, p) in log-target convention: logtarget − ½ pᵀM⁻¹p, per chain."""
    if inv_mass is None:
        return logtarget - 0.5 * chain_sum(torch.square(momentum))
    return logtarget - 0.5 * chain_sum(inv_mass * torch.square(momentum))


def sample_momentum(stream, position, inv_mass=None):
    """p ~ N(0, M): z / sqrt(M⁻¹) for diagonal M, z from ``stream`` at its
    ``MOMENTUM`` site."""
    z = draw_normal(stream, MOMENTUM, position)
    if inv_mass is None:
        return z
    return z * torch.rsqrt(inv_mass)


class PhasePoint(NamedTuple):
    position: torch.Tensor
    momentum: torch.Tensor
    logtarget: torch.Tensor
    gradlogtarget: torch.Tensor


def leapfrog_step(target, pp: PhasePoint, eps, inv_mass=None) -> PhasePoint:
    """One leapfrog step; ``eps`` is a scalar or a per-chain (C,) tensor."""
    eps = torch.as_tensor(eps, dtype=pp.position.dtype, device=pp.position.device)
    if eps.dim() == 1:
        eps = chain_view(eps, pp.position)
    p_half = pp.momentum + 0.5 * eps * pp.gradlogtarget
    vel = p_half if inv_mass is None else inv_mass * p_half
    x = pp.position + eps * vel
    lt, grad = target.logdensity_and_grad(x)
    p = p_half + 0.5 * eps * grad
    return PhasePoint(x, p, lt, grad)


def leap(target, pp: PhasePoint, eps, inv_mass=None, live=None) -> PhasePoint:
    """One step of ``leapfrog``: a chain whose ``live`` (a (C,) bool) is
    False keeps ``pp``; with ``live`` None every chain steps."""
    new = leapfrog_step(target, pp, eps, inv_mass)
    if live is None:
        return new
    return PhasePoint(*(
        torch.where(live.view((-1,) + (1,) * (a.dim() - 1)), a, b) for a, b in zip(new, pp)
    ))


def leapfrog(target, pp: PhasePoint, eps, n_steps, inv_mass=None) -> PhasePoint:
    """``n_steps`` leapfrog steps: an int, or a per-chain (C,) tensor.

    A tensor count costs one host read per call (its max and min).  When
    every chain has the same count, as under pooled tuning with shared
    jitter, no masking is done."""
    if isinstance(n_steps, int):
        n_max, n_min = n_steps, n_steps
    else:
        with tracing.timed("host_read.leapfrog_bounds"):
            bounds = torch.stack([n_steps.max(), n_steps.min()]).tolist()
        n_max, n_min = (int(t) for t in bounds)
    for k in range(n_max):
        pp = leap(target, pp, eps, inv_mass, None if k < n_min else k < n_steps)
    return pp


def find_reasonable_step_size(target, position, generator=None, max_iter=100,
                              momentum=None, stream=None):
    """Per-chain heuristic ε: double or halve from 1 until the one-step
    acceptance probability crosses 0.5 (Hoffman-Gelman Algorithm 4), as a
    masked batch loop.  The momentum is drawn at the ``INIT_MOMENTUM`` site
    of ``stream`` (``step_stream``: else of one keyed from ``generator``),
    or given (tests replay another package's draws)."""
    lt, grad = target.logdensity_and_grad(position)
    p0 = momentum
    if p0 is None:
        p0 = draw_normal(step_stream(stream, generator, position), INIT_MOMENTUM, position)
    h0 = hamiltonian(lt, p0)
    eps = torch.ones(position.shape[0], dtype=position.dtype, device=position.device)
    start = PhasePoint(position, p0, lt, grad)

    def ratio_for(eps):
        pp = leapfrog_step(target, start, eps)
        r = hamiltonian(pp.logtarget, pp.momentum) - h0
        return torch.where(torch.isnan(r), torch.full_like(r, -math.inf), r)

    r = ratio_for(eps)
    # a = +1 if the step is too small (accept prob > 0.5), else -1
    a = torch.where(r > math.log(0.5), 1.0, -1.0).to(eps.dtype)
    factor = torch.pow(2.0, a)
    active = a * r > -a * math.log(2.0)
    for _ in range(max_iter):
        with tracing.timed("host_read.step_search"):
            searching = bool(active.any())
        if not searching:
            break
        eps = torch.where(active, eps * factor, eps)
        active = active & (a * ratio_for(eps) > -a * math.log(2.0))
    return eps


def init_tune(tuner, target, position, leapstep, generator=None, step_size=None,
              momentum=None, stream=None):
    """The tuner state a gradient sampler starts from: ε = ``step_size``
    if given (a number, or a per-chain (C,) tensor taken as is), else the
    step-size search under dual averaging (its momentum from ``stream`` or
    ``generator``, or ``momentum``; tests replay draws), else ``leapstep``.
    Dual averaging then sets its μ from ε."""
    if step_size is None and isinstance(tuner, DualAveragingTuner):
        step0 = find_reasonable_step_size(target, position, generator, momentum=momentum,
                                          stream=stream)
    else:
        step0 = per_chain_step(leapstep if step_size is None else step_size,
                               position.shape[0], position.dtype, position.device)
    tune = tuner.init(step0)
    if isinstance(tuner, DualAveragingTuner):
        tune = tuner.set_mu_from_step(tune)
    return tune
