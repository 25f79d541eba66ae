"""Slice sampler, coordinate-wise (Neal 2003), batch-first (counterpart of
klara_tpu/samplers/slice_sampler.py).  For each coordinate i:

    log u' = log(rand()) + logπ(x)
    r ~ U(0,1);  L = x_i − r·w_i;  R = x_i + (1−r)·w_i
    step out:  while logπ(x|L) > log u': L −= w_i   (and the same for R)
    shrink:    repeat x_i' ~ U(L, R); accept if logπ > log u',
               else move the violated end to x_i'

Both loops are capped (``max_stepouts``, ``max_shrinks``); a chain whose
shrinkage exhausts its cap keeps its coordinate, which is always inside the
slice.  The chains run in lockstep under a per-chain ``alive`` mask: a loop
runs while any chain is alive and a finished chain's interval is frozen, so
a chain's k-th shrink draw is the k-th draw of the loop.  Each loop
iteration evaluates the log-density of the whole batch and reads one flag
back from the device (the tracer's timed counter ``host_read.slice_shrink``).
The k-th shrink draw of coordinate i is keyed at its own site
(``ops.keyed``: offset ``FIXED_SITES`` + i·``max_shrinks`` + k), so on a
chains mesh a rank's loop runs as long as its own chains need and issues no
collective.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from klara_tpu_torch.ops.keyed import FIXED_SITES, SLICE_INTERVAL, SLICE_LEVEL
from klara_tpu_torch.samplers.base import (
    Info,
    Sampler,
    draw_uniform,
    per_chain_step,
    step_stream,
    tensor_like,
)
from klara_tpu_torch.tuners.tuners import TuneState
from klara_tpu_torch.utils import tracing


def _any(mask) -> bool:
    with tracing.timed("host_read.slice_shrink"):
        return bool(mask.any())


class SliceState(NamedTuple):
    position: torch.Tensor   # (C, D)
    logtarget: torch.Tensor  # (C,)
    tune: TuneState


class SliceDraws(NamedTuple):
    """The draws of one sweep, to replay another stream."""

    slice_u: torch.Tensor   # (C, D) U(0, 1): the slice level is log(u) + logπ(x)
    interval_u: torch.Tensor  # (C, D) U(0, 1): where the first interval lies around x_i
    shrink_u: torch.Tensor  # (C, D, K) U(0, 1), K >= the shrink iterations a coordinate takes


@dataclasses.dataclass(frozen=True)
class SliceSampler(Sampler):
    widths: object = 1.0  # scalar or per-coordinate (D,) vector
    stepout: bool = True
    max_stepouts: int = 100
    max_shrinks: int = 100

    def init(self, target, position, generator=None, step_size=None, tuner=None,
             stream=None):
        tune = (tuner or self.default_tuner()).init(
            per_chain_step(1.0, position.shape[0], position.dtype, position.device))
        return SliceState(position, target.logdensity(position), tune)

    def keyed_sites(self, position) -> int:
        return FIXED_SITES + position.shape[-1] * self.max_shrinks

    def _step_out(self, lt_at, end, w, logu):
        """Move ``end`` by ``w`` while it lies inside the slice, per chain."""
        it = 0
        alive = lt_at(end) > logu
        while it < self.max_stepouts and _any(alive):
            end = torch.where(alive, end + w, end)
            it += 1
            alive = alive & (lt_at(end) > logu)
        return end

    def step(self, state: SliceState, target, generator=None, draws=None, stream=None):
        """One sweep over the coordinates for every chain; ``draws`` (a
        ``SliceDraws``) may be given to replay another stream."""
        x, lt = state.position, state.logtarget
        x0 = x
        C, d = x.shape
        widths = tensor_like(self.widths, x).expand(d)
        if draws is None:
            stream = step_stream(stream, generator, x)
            slice_u = draw_uniform(stream, SLICE_LEVEL, (C, d), x)
            interval_u = draw_uniform(stream, SLICE_INTERVAL, (C, d), x)
        else:
            slice_u, interval_u = draws.slice_u, draws.interval_u

        for i in range(d):
            w, xi = widths[i], x[:, i]
            logu = torch.log(slice_u[:, i]) + lt
            r = interval_u[:, i]
            left = xi - r * w
            right = xi + (1.0 - r) * w
            x_try = x.clone()

            def lt_at(v):
                x_try[:, i] = v
                return target.logdensity(x_try)

            if self.stepout:
                left = self._step_out(lt_at, left, -w, logu)
                right = self._step_out(lt_at, right, w, logu)

            prop = xi
            accepted = torch.zeros(C, dtype=torch.bool, device=x.device)
            alive = ~accepted
            it = 0
            while it < self.max_shrinks and _any(alive):
                uk = (draw_uniform(stream, FIXED_SITES + i * self.max_shrinks + it, (C,), x)
                      if draws is None else draws.shrink_u[:, i, it])
                new = left + uk * (right - left)
                ok = lt_at(new) > logu
                left = torch.where(alive & ~ok & (new < xi), new, left)
                right = torch.where(alive & ~ok & (new > xi), new, right)
                prop = torch.where(alive, new, prop)
                accepted = torch.where(alive, ok, accepted)
                alive = ~accepted
                it += 1
            xi_new = torch.where(accepted, prop, xi)
            # the log-density at the accepted point is evaluated once more,
            # as the JAX package does, so both carry the same value
            lt = torch.where(accepted, lt_at(xi_new), lt)
            x = x_try  # holds xi_new at coordinate i after the last evaluation

        moved = (x != x0).any(-1)
        info = Info(accept=moved, accept_stat=moved.to(x.dtype), logtarget=lt)
        return SliceState(x, lt, state.tune), info
