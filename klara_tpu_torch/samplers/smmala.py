"""Simplified-manifold MALA (Girolami & Calderhead 2011), batch-first
(counterpart of klara_tpu/samplers/smmala.py):

    G  = tensor(x)  (−Hessian of logπ; optionally softabs-projected)
    μ  = x + (ε/2)·G⁻¹∇logπ(x)
    x' = μ + √ε·chol(G⁻¹)·z
    ratio = logπ(x') − logπ(x)
          + ½( logdet(ε·G⁻¹)  + (x'−μ)ᵀ G  (x'−μ)/ε )
          − ½( logdet(ε·G'⁻¹) + (x−μ')ᵀ G' (x−μ')/ε )

Every chain carries its own (D, D) tensor and inverse; inverse and Cholesky
factor are batched library calls that report a failure as NaN (the chain
then rejects) and read no status back.  Value and gradient come from
``Target.logdensity_grad_tensor``, hence from the fused kernel where the
target has one; the tensor is autograd's Hessian of ``logdensity_fn`` unless
the target gives ``tensor_fn``.  The drift step ε is the per-chain
``tune.step``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from klara_tpu_torch.ops.keyed import PROPOSAL
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    accept_prob,
    cholesky_or_nan,
    draw_normal,
    inverse_or_nan,
    metropolis_accept,
    per_chain_step,
    step_stream,
)
from klara_tpu_torch.stats.metrics import softabs
from klara_tpu_torch.tuners.tuners import TuneState


class SMMALAState(NamedTuple):
    position: torch.Tensor       # (C, D)
    logtarget: torch.Tensor      # (C,)
    gradlogtarget: torch.Tensor  # (C, D)
    tensor: torch.Tensor         # (C, D, D)
    invtensor: torch.Tensor      # (C, D, D)
    firstterm: torch.Tensor      # (C, D): G⁻¹ ∇logπ
    tune: TuneState


def _matvec(m, v):
    return (m @ v[..., None])[..., 0]


def _logdet(m):
    return torch.linalg.slogdet(m)[1]


@dataclasses.dataclass(frozen=True)
class SMMALA(Sampler):
    driftstep: float = 1.0
    transform: Optional[Union[str, object]] = None  # None | 'softabs' | callable
    softabs_alpha: float = 1000.0

    def _transform(self, G):
        if self.transform is None:
            return G
        if self.transform == "softabs":
            return softabs(G, self.softabs_alpha)
        return self.transform(G)

    def _derivs(self, target, x):
        lt, grad, G = target.logdensity_grad_tensor(x)
        G = self._transform(G)
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        Ginv = inverse_or_nan(G + 1e-10 * eye)
        return lt, grad, G, Ginv, _matvec(Ginv, grad)

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        step0 = per_chain_step(self.driftstep if step_size is None else step_size,
                               position.shape[0], position.dtype, position.device)
        tune = (tuner or self.default_tuner()).init(step0)
        return SMMALAState(position, *self._derivs(target, position), tune)

    def step(self, state: SMMALAState, target, generator=None, z=None, u=None, stream=None):
        """One transition for every chain; ``z`` and ``u`` may be given to
        replay draws."""
        x, lt = state.position, state.logtarget
        eps = state.tune.step
        eps_v, eps_m = eps[:, None], eps[:, None, None]
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        if z is None or u is None:
            stream = step_stream(stream, generator, x)
        if z is None:
            z = draw_normal(stream, PROPOSAL, x)

        mu = x + 0.5 * eps_v * state.firstterm
        chol_inv = cholesky_or_nan(state.invtensor + 1e-10 * eye)
        x_new = mu + torch.sqrt(eps_v) * _matvec(chol_inv, z)
        lt_new, grad_new, G_new, Ginv_new, first_new = self._derivs(target, x_new)

        # the JAX package's order: the forward half-term, then the reverse
        diff_fwd = x_new - mu
        ratio = lt_new - lt
        ratio = ratio + 0.5 * (
            _logdet(eps_m * state.invtensor)
            + (diff_fwd * _matvec(state.tensor, diff_fwd)).sum(-1) / eps
        )
        mu_rev = x_new + 0.5 * eps_v * first_new
        diff_rev = x - mu_rev
        ratio = ratio - 0.5 * (
            _logdet(eps_m * Ginv_new) + (diff_rev * _matvec(G_new, diff_rev)).sum(-1) / eps
        )
        ratio = torch.where(torch.isnan(ratio), -torch.inf, ratio)
        accept = metropolis_accept(ratio, stream, u)

        def pick(new, old):
            return torch.where(accept.view((-1,) + (1,) * (new.dim() - 1)), new, old)

        new_state = SMMALAState(
            position=pick(x_new, x),
            logtarget=pick(lt_new, lt),
            gradlogtarget=pick(grad_new, state.gradlogtarget),
            tensor=pick(G_new, state.tensor),
            invtensor=pick(Ginv_new, state.invtensor),
            firstterm=pick(first_new, state.firstterm),
            tune=state.tune,
        )
        return new_state, Info(accept=accept, accept_stat=accept_prob(ratio),
                               logtarget=new_state.logtarget)
