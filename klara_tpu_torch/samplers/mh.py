"""Metropolis-Hastings, random-walk and general proposals, batch-first
(counterpart of klara_tpu/samplers/mh.py).

Positions are (C, ...).  The random walk proposes x' = x + step·σ·z with
z ~ N(0, I) per chain, where σ is a scalar, a per-coordinate vector or a
lower Cholesky factor (matrix, applied to each row as σ z).  A general
proposal is ``proposal_fn(x, step) -> Distribution`` over the (C, ...)
batch, with ``step`` the (C,) tuned scale, drawn once per chain from a
keyed stream (``ops.keyed``, kernel K2 on the card) at counter (step,
``MH_SITE``), so on a mesh a rank draws only its own chains.  ``MCJob``
owns the stream: it keys one per ``run`` or ``resume`` from the generator
and hands it to ``step`` at each step's index.  Called without one
(directly, or as a Gibbs job's nested sampler) ``step`` keys a fresh
stream from the generator at every step.  The proposal's ``sample`` is
handed the stream, not a ``torch.Generator`` (see
``distributions.core.Distribution.sample``).  Asymmetric proposals add
logpdf(q(x'→x)) − logpdf(q(x→x')), summed per chain, and proposals whose
logpdf omits its normaliser add the normalisers' difference as well.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from klara_tpu_torch.distributions.core import draw_per_chain
from klara_tpu_torch.models.graph import chain_sum
from klara_tpu_torch.ops.keyed import MH_SITE, KeyedStream, check_device
from klara_tpu_torch.parallel.mesh import active_block
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    accept_prob,
    chain_view,
    draw_normal,
    metropolis_accept,
    per_chain_step,
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

    @property
    def keyed(self) -> bool:
        """Whether ``step`` draws from a keyed stream (a proposal
        distribution), which a job then hands it."""
        return self.proposal_fn is not None

    def init(self, target, position, generator=None, step_size=None, tuner=None):
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
        fresh one from ``generator``); its site is set here."""
        x, lt = state.position, state.logtarget
        scale = state.tune.step

        if self.proposal_fn is None:
            if z is None:
                z = draw_normal(x, generator)
            x_new = self._propose(x, scale, z)
            ratio = target.logdensity(x_new) - lt
            lt_new = ratio + lt
        else:
            fwd = self.proposal_fn(x, scale)
            if z is None:
                if stream is None:
                    block = active_block()
                    stream = KeyedStream.for_run(generator, x.device, x.shape[0],
                                                 0 if block is None else block.offset)
                check_device("the stream", stream.device, x.device)
                x_new = draw_per_chain(fwd, x, stream.at(site=MH_SITE))
            else:
                x_new = draw_per_chain(fwd, x, generator, z)
            lt_new = target.logdensity(x_new)
            ratio = lt_new - lt
            if not self.symmetric:
                rev = self.proposal_fn(x_new, scale)
                ratio = ratio + chain_sum(rev.logpdf(x)) - chain_sum(fwd.logpdf(x_new))
                if not self.normalised:
                    ratio = ratio + chain_sum(fwd.lognormaliser()) - chain_sum(
                        rev.lognormaliser()
                    )

        accept = metropolis_accept(ratio, generator, u)
        acc = chain_view(accept, x)
        position = torch.where(acc, x_new, x)
        logtarget = torch.where(accept, lt_new, lt)
        info = Info(
            accept=accept,
            accept_stat=accept_prob(ratio),
            logtarget=logtarget,
        )
        return state._replace(position=position, logtarget=logtarget), info
