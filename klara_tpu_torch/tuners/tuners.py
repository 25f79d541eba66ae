"""Step-size tuners as pure state updaters, batch-first.

Counterpart of klara_tpu/tuners/tuners.py.  Every field of ``TuneState``
carries a leading chains axis (C,), as the JAX state does under the job's
vmap; the updates are elementwise, so one call updates every chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch


def logistic_rate_score(x, k=7.0):
    """Stretched logistic score in (0, 2): 2 / (1 + e^(−k·x))."""
    return 2.0 / (1.0 + torch.exp(-k * x))


def erf_rate_score(x, k=3.0):
    """erf-based score in (0, 2)."""
    return torch.erf(k * x) + 1.0


class TuneState(NamedTuple):
    step: torch.Tensor         # step size, (C,)
    accepted: torch.Tensor     # accepted proposals in the current period, float
    proposed: torch.Tensor     # proposed in the current period, int32
    totproposed: torch.Tensor  # total proposed across completed periods, int32
    rate: torch.Tensor         # last computed acceptance rate (NaN before the first)
    extra: Any = ()            # tuner-specific adaptation state


@dataclasses.dataclass(frozen=True)
class Tuner:
    """Base: no-op tuner."""

    period: int = dataclasses.field(default=100, kw_only=True)

    def init(self, step0) -> TuneState:
        step0 = torch.as_tensor(step0)
        f = step0.dtype if step0.is_floating_point() else torch.float32
        kw = dict(device=step0.device)
        return TuneState(
            step=step0,
            accepted=torch.zeros(step0.shape, dtype=f, **kw),
            proposed=torch.zeros(step0.shape, dtype=torch.int32, **kw),
            totproposed=torch.zeros(step0.shape, dtype=torch.int32, **kw),
            rate=torch.full(step0.shape, math.nan, dtype=f, **kw),
            extra=self._extra_init(step0),
        )

    def _extra_init(self, step0):
        return ()

    def update(self, tune: TuneState, accept, accept_stat, burnin: int) -> TuneState:
        """accept: 0/1 this step (or a pooled fraction); accept_stat: the
        acceptance probability in [0, 1]."""
        accepted = tune.accepted + torch.as_tensor(accept).to(tune.accepted.dtype)
        proposed = tune.proposed + 1
        # the period that straddles the burnin boundary still fires
        at_boundary = (proposed % self.period == 0) & (tune.totproposed <= burnin)
        rate = accepted / proposed.to(accepted.dtype)

        new_step, new_extra = self._tune(
            tune._replace(accepted=accepted, proposed=proposed, rate=rate),
            accept_stat,
            at_boundary,
            burnin,
        )
        totproposed = torch.where(at_boundary, tune.totproposed + proposed, tune.totproposed)
        accepted = torch.where(at_boundary, torch.zeros_like(accepted), accepted)
        proposed = torch.where(at_boundary, torch.zeros_like(proposed), proposed)
        rate = torch.where(at_boundary, rate, tune.rate)
        return TuneState(new_step, accepted, proposed, totproposed, rate, new_extra)

    def _tune(self, tune, accept_stat, at_boundary, burnin):
        return tune.step, tune.extra

    def finalize(self, tune: TuneState) -> TuneState:
        """Freeze the tune state for post-adaptation sampling (identity here)."""
        return tune


@dataclasses.dataclass(frozen=True)
class VanillaTuner(Tuner):
    """No-op tuner."""


@dataclasses.dataclass(frozen=True)
class AcceptanceRateTuner(Tuner):
    """Scale the step by score(observed rate − target rate) at every
    period boundary during burnin."""

    targetrate: float = 0.234
    score: str = "logistic"  # 'logistic' | 'erf'
    k: Optional[float] = None

    def _score(self, x):
        if self.score == "logistic":
            return logistic_rate_score(x, 7.0 if self.k is None else self.k)
        if self.score == "erf":
            return erf_rate_score(x, 3.0 if self.k is None else self.k)
        raise ValueError(f"unknown score {self.score!r}")

    def _tune(self, tune, accept_stat, at_boundary, burnin):
        scaled = tune.step * self._score(tune.rate - self.targetrate)
        return torch.where(at_boundary, scaled, tune.step), tune.extra


class DualAveragingExtra(NamedTuple):
    mu: torch.Tensor       # log(10 * step0)
    eps_bar: torch.Tensor  # averaged step
    h_bar: torch.Tensor    # averaged (target - a) statistic
    count: torch.Tensor    # adaptation step counter, int32


@dataclasses.dataclass(frozen=True)
class DualAveragingTuner(Tuner):
    """Hoffman-Gelman dual averaging (Algorithm 6): adapts every step for
    the first ``nadapt`` iterations, then freezes step = εbar."""

    targetrate: float = 0.8
    nadapt: int = 1000
    gamma: float = 0.05
    t0: int = 10
    kappa: float = 0.75

    def _extra_init(self, step0):
        f = step0.dtype if step0.is_floating_point() else torch.float32
        step0 = step0.to(f)
        return DualAveragingExtra(
            mu=torch.log(10.0 * step0),
            eps_bar=torch.ones_like(step0),
            h_bar=torch.zeros_like(step0),
            count=torch.zeros(step0.shape, dtype=torch.int32, device=step0.device),
        )

    def _tune(self, tune, accept_stat, at_boundary, burnin):
        ex: DualAveragingExtra = tune.extra
        count = ex.count + 1
        cf = count.to(tune.step.dtype)
        adapting = count <= self.nadapt

        h_weight = 1.0 / (cf + self.t0)
        h_bar = (1.0 - h_weight) * ex.h_bar + h_weight * (self.targetrate - accept_stat)
        step = torch.exp(ex.mu - torch.sqrt(cf) * h_bar / self.gamma)
        eps_weight = cf ** (-self.kappa)
        eps_bar = torch.exp(
            (1.0 - eps_weight) * torch.log(ex.eps_bar) + eps_weight * torch.log(step)
        )
        new_step = torch.where(adapting, step, ex.eps_bar)
        new_extra = DualAveragingExtra(
            mu=ex.mu,
            eps_bar=torch.where(adapting, eps_bar, ex.eps_bar),
            h_bar=torch.where(adapting, h_bar, ex.h_bar),
            count=count,
        )
        return new_step, new_extra

    def finalize(self, tune: TuneState) -> TuneState:
        """step := εbar at the warmup/sampling boundary; a zero-length warmup
        (count == 0) keeps the raw step."""
        ex: DualAveragingExtra = tune.extra
        return tune._replace(step=torch.where(ex.count > 0, ex.eps_bar, tune.step))

    def set_mu_from_step(self, tune: TuneState) -> TuneState:
        """Re-anchor μ = log(10·step) after an initial step-size search."""
        return tune._replace(extra=tune.extra._replace(mu=torch.log(10.0 * tune.step)))


class RobertsRosenthalExtra(NamedTuple):
    batch: torch.Tensor  # completed adaptation batches, (C,) int32


@dataclasses.dataclass(frozen=True)
class RobertsRosenthalTuner(Tuner):
    """Per-coordinate ±δ adaptation of logσ (Roberts & Rosenthal 2009): after
    each batch of ``period`` proposals, δ = min(0.01, batch^-½) and
    logσ_i moves up or down by δ as coordinate i's observed rate lies above
    or below the target.

    ``tune.step`` holds logσ, (C, D); ``accept`` is the (C, D) per-coordinate
    acceptance of one AMWG sweep.  The adaptation never stops: its
    diminishing δ keeps the chain ergodic, so ``burnin`` is not consulted.
    """

    targetrate: float = 0.44
    period: int = dataclasses.field(default=50, kw_only=True)

    def _extra_init(self, step0):
        return RobertsRosenthalExtra(
            batch=torch.zeros(step0.shape[:1], dtype=torch.int32, device=step0.device)
        )

    def init_vector(self, logsigma0) -> TuneState:
        """The tune state of a (C, D) logσ: per-coordinate acceptance counts,
        per-chain counters."""
        logsigma0 = torch.as_tensor(logsigma0)
        per_chain = dict(device=logsigma0.device)
        C = logsigma0.shape[:1]
        return TuneState(
            step=logsigma0,
            accepted=torch.zeros_like(logsigma0),
            proposed=torch.zeros(C, dtype=torch.int32, **per_chain),
            totproposed=torch.zeros(C, dtype=torch.int32, **per_chain),
            rate=torch.full(C, math.nan, dtype=logsigma0.dtype, **per_chain),
            extra=self._extra_init(logsigma0),
        )

    def update(self, tune: TuneState, accept, accept_stat=None, burnin: int = 0) -> TuneState:
        f = tune.step.dtype
        accepted = tune.accepted + torch.as_tensor(accept).to(f)
        proposed = tune.proposed + 1
        at_boundary = proposed % self.period == 0  # (C,)
        rate = accepted / torch.clamp_min(proposed, 1).to(f)[:, None]

        batch = tune.extra.batch + at_boundary.to(torch.int32)
        # batch 0 gives inf, and min(0.01, inf) = 0.01 (an integer tensor
        # cannot take a negative power)
        delta = torch.clamp_max(batch.to(f) ** -0.5, 0.01)[:, None]
        adjusted = tune.step + torch.where(rate < self.targetrate, -delta, delta)
        fire = at_boundary[:, None]
        step = torch.where(fire, adjusted, tune.step)

        totproposed = torch.where(at_boundary, tune.totproposed + proposed, tune.totproposed)
        accepted = torch.where(fire, torch.zeros_like(accepted), accepted)
        mean_rate = torch.where(at_boundary, rate.mean(-1), tune.rate)
        proposed = torch.where(at_boundary, torch.zeros_like(proposed), proposed)
        return TuneState(step, accepted, proposed, totproposed, mean_rate,
                         RobertsRosenthalExtra(batch))
