"""Sampler protocol, batch-first (counterpart of klara_tpu/samplers/base.py).

A sampler is a frozen dataclass of static hyper-parameters with

    sampler.init(target, position, generator, step_size=None, tuner=None) -> state
    sampler.step(state, target, generator)                               -> (state, Info)

where every state field and every ``Info`` field carries a leading chains
axis.  Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from klara_tpu_torch.tuners.tuners import Tuner, VanillaTuner


class Info(NamedTuple):
    """Per-step diagnostics: ``accept`` (C,) bool, ``accept_stat`` (C,)
    acceptance probability, ``logtarget`` (C,) after the step, ``extras``
    a dict of sampler-specific diagnostics."""

    accept: torch.Tensor
    accept_stat: torch.Tensor
    logtarget: torch.Tensor
    extras: Any = ()


def metropolis_accept(log_ratio, generator=None, u=None):
    """Accept where log_ratio > log(u), u ~ U(0, 1) per chain; a NaN ratio
    rejects.  ``u`` may be given (tests replay another package's draws)."""
    if u is None:
        u = torch.rand(
            log_ratio.shape, generator=generator, device=log_ratio.device,
            dtype=log_ratio.dtype,
        )
    return log_ratio > torch.log(u)


def per_chain_step(step, C, dtype, device):
    """A step size as a (C,) tensor: a tensor (per chain, or one that
    broadcasts to (C,)) is taken as is, a number is filled."""
    if torch.is_tensor(step):
        return step.to(dtype=dtype, device=device).expand(C)
    return torch.full((C,), float(step), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base class. Subclasses define ``init`` and ``step``."""

    def init(self, target, position, generator=None, step_size=None, tuner=None):
        raise NotImplementedError

    def step(self, state, target, generator=None):
        raise NotImplementedError

    # statistic the tuner consumes: 'accept' (0/1) or 'accept_stat'
    tuner_statistic = "accept"
    # samplers with built-in adaptation make the job skip the tuner update
    self_tuning = False

    def default_tuner(self) -> Tuner:
        return VanillaTuner()

    def bind_tuner(self, tuner: Tuner) -> "Sampler":
        """Specialise the static config to the tuner in use."""
        return self
