"""Adaptive Metropolis-within-Gibbs: a per-coordinate random walk, batch-first
(counterpart of klara_tpu/samplers/amwg.py).

  * a sweep visits the coordinates one at a time, proposing
    x_i' ~ TruncatedNormal(x_i, e^{logσ_i}; lower_i, upper_i) and accepting
    with the truncation's asymmetry correction
    ratio += logZ(x_i) − logZ(x_i'), logZ the truncated normal's
    log-normaliser;
  * each coordinate's logσ is adapted by the Roberts-Rosenthal ±δ rule every
    ``period`` sweeps from its own acceptance count.

The sweep is sequential by construction (each conditional sees the
coordinates already updated in it): a Python loop over the D coordinates,
each step of which evaluates the log-density of the whole batch of chains.
It reads nothing back from the device.  Self-tuning: ``tune.step`` holds the
(C, D) logσ.  ``Info.accept`` is the accepted *fraction* of the sweep, (C,),
not a boolean; the diagnostics ``logsigma`` and ``accept_vec`` are (C, D).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from klara_tpu_torch.distributions.core import (
    lognormalise_truncated_normal,
    truncated_standard_normal,
)
from klara_tpu_torch.ops.keyed import AMWG_ACCEPT, AMWG_PROPOSAL
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    draw_normal,
    draw_uniform,
    step_stream,
    tensor_like,
)
from klara_tpu_torch.tuners.tuners import RobertsRosenthalTuner, TuneState


class AMWGState(NamedTuple):
    position: torch.Tensor   # (C, D)
    logtarget: torch.Tensor  # (C,)
    tune: TuneState          # step: (C, D) logσ; accepted: per-coordinate counts


@dataclasses.dataclass(frozen=True)
class AMWG(Sampler):
    sigma0: float = 1.0             # initial per-coordinate proposal sd
    lower: Optional[object] = None  # truncation bounds (scalar or (D,) vector)
    upper: Optional[object] = None
    targetrate: float = 0.44
    period: int = 50

    self_tuning = True

    def _tuner(self):
        return RobertsRosenthalTuner(targetrate=self.targetrate, period=self.period)

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        sigma0 = self.sigma0 if step_size is None else step_size
        logsigma0 = torch.log(tensor_like(sigma0, position)).expand(position.shape).contiguous()
        return AMWGState(position, target.logdensity(position),
                         self._tuner().init_vector(logsigma0))

    def _bounds(self, x):
        lo = tensor_like(-math.inf if self.lower is None else self.lower, x)
        hi = tensor_like(math.inf if self.upper is None else self.upper, x)
        return lo.expand(x.shape), hi.expand(x.shape)

    def step(self, state: AMWGState, target, generator=None, z=None, u=None, stream=None):
        """One sweep for every chain.  ``z`` (C, D) replays the proposals'
        draws (standard normal where the sampler has no bounds, else the
        U(0, 1) draw that the truncated normal's inverse CDF maps) and ``u``
        (C, D) the accept uniforms; else each is one keyed (C, D) draw, the
        coordinate its element index."""
        x, lt = state.position, state.logtarget
        d = x.shape[-1]
        bounded = self.lower is not None or self.upper is not None
        lo, hi = self._bounds(x)
        sigma = torch.exp(state.tune.step)
        if z is None or u is None:
            stream = step_stream(stream, generator, x)
        if z is None:
            z = (draw_uniform(stream, AMWG_PROPOSAL, x.shape, x) if bounded
                 else draw_normal(stream, AMWG_PROPOSAL, x))
        if u is None:
            u = draw_uniform(stream, AMWG_ACCEPT, x.shape, x)
        logu = torch.log(u)
        acc_vec = torch.zeros_like(x)

        for i in range(d):
            sigma_i, xi = sigma[:, i], x[:, i]
            if bounded:
                zi = truncated_standard_normal(
                    (lo[:, i] - xi) / sigma_i, (hi[:, i] - xi) / sigma_i, z[:, i]
                ).to(x.dtype)
            else:
                zi = z[:, i]
            xi_new = xi + sigma_i * zi
            x_prop = x.clone()
            x_prop[:, i] = xi_new
            lt_new = target.logdensity(x_prop)
            ratio = lt_new - lt
            if bounded:
                ratio = ratio + lognormalise_truncated_normal(
                    xi, sigma_i, lo[:, i], hi[:, i]
                ) - lognormalise_truncated_normal(xi_new, sigma_i, lo[:, i], hi[:, i])
            accept = ratio > logu[:, i]
            x = torch.where(accept[:, None], x_prop, x)
            lt = torch.where(accept, lt_new, lt)
            acc_vec[:, i] = accept.to(x.dtype)

        tune = self._tuner().update(state.tune, acc_vec, acc_vec)
        mean_acc = acc_vec.mean(-1)
        info = Info(
            accept=mean_acc,
            accept_stat=mean_acc,
            logtarget=lt,
            extras={"logsigma": tune.step, "accept_frac": mean_acc, "accept_vec": acc_vec},
        )
        return AMWGState(x, lt, tune), info
