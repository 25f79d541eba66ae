"""Metropolis-Hastings, random-walk and general proposals, batch-first
(counterpart of klara_tpu/samplers/mh.py).

Positions are (C, ...).  The random walk proposes x' = x + step·σ·z with
z ~ N(0, I) per chain, where σ is a scalar, a per-coordinate vector or a
lower Cholesky factor (matrix, applied to each row as σ z).  A general
proposal is ``proposal_fn(x, step) -> Distribution`` over the (C, ...)
batch, with ``step`` the (C,) tuned scale, drawn once per chain.  Every
draw is keyed (``ops.keyed``, kernel K2 on the card): the proposal (the
walk's normal, or the proposal distribution's draw) at the window's
``PROPOSAL`` site, which is ``MH_SITE`` in ``MCJob``'s window, and the
accept uniform at ``ACCEPT``.  ``MCJob`` keys the stream once per ``run``,
``resume`` or ``run_phased`` from the generator and hands it to ``step`` at
each step's index, a nested Gibbs block at its sweep in its own window;
called without one, ``step`` keys a fresh stream from the generator at
every call.  The proposal's ``sample`` is handed the stream, not a
``torch.Generator`` (see ``distributions.core.Distribution.sample``).  Asymmetric proposals add
logpdf(q(x'→x)) − logpdf(q(x→x')), summed per chain, and proposals whose
logpdf omits its normaliser add the normalisers' difference as well.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from klara_tpu_torch.distributions.core import draw_per_chain
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


class MHState(NamedTuple):
    position: torch.Tensor   # (C, ...)
    logtarget: torch.Tensor  # (C,)
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class MH(Sampler):
    """Random-walk Metropolis by default; ``proposal_fn`` for a general
    (possibly asymmetric) proposal."""

    sigma: Any = 1.0
    proposal_fn: Optional[Callable] = None  # (x, scale) -> Distribution
    symmetric: bool = True
    # False: the proposal's logpdf omits its normaliser, which the ratio
    # then takes from `proposal.lognormaliser()`
    normalised: bool = True

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        """``step_size`` (a number or a (C,) tensor) starts the tuned scale
        (default 1); it stays floating for integer positions."""
        f = position.dtype if position.is_floating_point() else torch.float32
        step0 = per_chain_step(1.0 if step_size is None else step_size, position.shape[0], f,
                               position.device)
        tune = (tuner or self.default_tuner()).init(step0)
        return MHState(position, target.logdensity(position), tune)

    def _propose(self, x, scale, z):
        sigma = self.sigma
        if not isinstance(sigma, (int, float)):
            sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        if torch.is_tensor(sigma) and sigma.dim() == 2:
            return x + chain_view(scale, x) * (z @ sigma.T)
        return x + chain_view(scale, x) * sigma * z

    def step(self, state: MHState, target, generator=None, z=None, u=None, stream=None):
        """One MH transition for every chain.  ``z`` (the proposal's
        standard draw) and ``u`` (the accept uniform) may be given to replay
        draws.  ``stream`` is the run's keyed stream at this step (None: a
        fresh one from ``generator``); the sites are set here."""
        x, lt = state.position, state.logtarget
        scale = state.tune.step
        if z is None or u is None:
            stream = step_stream(stream, generator, x)

        if self.proposal_fn is None:
            if z is None:
                z = draw_normal(stream, PROPOSAL, x)
            x_new = self._propose(x, scale, z)
            ratio = target.logdensity(x_new) - lt
            lt_new = ratio + lt
        else:
            fwd = self.proposal_fn(x, scale)
            x_new = draw_per_chain(fwd, x, stream.window_site(PROPOSAL) if z is None else None, z)
            lt_new = target.logdensity(x_new)
            ratio = lt_new - lt
            if not self.symmetric:
                rev = self.proposal_fn(x_new, scale)
                ratio = ratio + chain_sum(rev.logpdf(x)) - chain_sum(fwd.logpdf(x_new))
                if not self.normalised:
                    ratio = ratio + chain_sum(fwd.lognormaliser()) - chain_sum(
                        rev.lognormaliser()
                    )

        accept = metropolis_accept(ratio, stream, u)
        acc = chain_view(accept, x)
        position = torch.where(acc, x_new, x)
        logtarget = torch.where(accept, lt_new, lt)
        info = Info(
            accept=accept,
            accept_stat=accept_prob(ratio),
            logtarget=logtarget,
        )
        return state._replace(position=position, logtarget=logtarget), info
