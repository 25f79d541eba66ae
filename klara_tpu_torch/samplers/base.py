"""Sampler protocol, batch-first (counterpart of klara_tpu/samplers/base.py).

A sampler is a frozen dataclass of static hyper-parameters with

    sampler.init(target, position, generator, step_size=None, tuner=None, stream=None) -> state
    sampler.step(state, target, generator, stream=None)                     -> (state, Info)

where every state field and every ``Info`` field carries a leading chains
axis.  Every draw is a keyed draw (``ops.keyed``, kernel K2 on the card) at
a site of the sampler's window (the offsets of ``ops.keyed``'s table), so a
chain's numbers are a function of the run key, its global index, the step
and the site: a rank draws exactly its own chains.  A job hands ``stream``
(its run's stream at the step, in its window); called without one, a
sampler keys a stream afresh from ``generator`` at each call
(``step_stream``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from klara_tpu_torch.ops.keyed import ACCEPT, FIXED_SITES, KeyedStream, check_device
from klara_tpu_torch.parallel.mesh import active_block
from klara_tpu_torch.tuners.tuners import Tuner, VanillaTuner


class Info(NamedTuple):
    """Per-step diagnostics: ``accept`` (C,) bool, ``accept_stat`` (C,)
    acceptance probability, ``logtarget`` (C,) after the step, ``extras``
    a dict of sampler-specific diagnostics."""

    accept: torch.Tensor
    accept_stat: torch.Tensor
    logtarget: torch.Tensor
    extras: Any = ()


def metropolis_accept(log_ratio, stream=None, u=None):
    """Accept where log_ratio > log(u), u ~ U(0, 1) per chain drawn from
    ``stream`` at its ``ACCEPT`` site; a NaN ratio rejects.  ``u`` may be
    given (tests replay another package's draws)."""
    if u is None:
        u = draw_uniform(stream, ACCEPT, log_ratio.shape, log_ratio)
    return log_ratio > torch.log(u)


def chain_view(t, like):
    """A (C,) tensor shaped to broadcast against the (C, ...) ``like``."""
    return t.view((-1,) + (1,) * (like.dim() - 1))


def accept_prob(log_ratio):
    """min(1, e^ratio), computed without overflow."""
    return torch.clamp_max(torch.exp(torch.clamp_max(log_ratio, 0.0)), 1.0)


def step_stream(stream, generator, like):
    """The keyed stream a sampler draws from at one call: ``stream`` (a
    job's, at the step and window it hands over), else one keyed afresh
    from ``generator`` (one draw) over the chains of the batch-first
    ``like``, at step 0 in MCJob's window; inside ``chain_context`` of a
    split block those are the block's chains, named by their global
    indices.  Either lies on ``like``'s device, or this raises."""
    if stream is None:
        block = active_block()
        return KeyedStream.for_run(generator, like.device, like.shape[0],
                                   0 if block is None else block.offset)
    check_device("the stream", stream.device, like.device)
    return stream


def _keyed_dtype(dtype):
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def draw_normal(stream, offset, like):
    """N(0, 1) at ``like``'s shape (chains axis first) and dtype, from
    ``stream`` at its window's ``offset``."""
    return stream.window_site(offset).normal(like.shape, _keyed_dtype(like.dtype)).to(like.dtype)


def draw_uniform(stream, offset, shape, like):
    """U(0, 1) of ``shape`` (chains axis first) in ``like``'s dtype, from
    ``stream`` at its window's ``offset``."""
    return stream.window_site(offset).uniform(shape, _keyed_dtype(like.dtype)).to(like.dtype)


def tensor_like(value, like):
    """``value`` as a tensor of ``like``'s dtype on its device.  A Python
    number becomes a 0-d fill: a copy from host memory would make the host
    wait for the device at every call."""
    if torch.is_tensor(value):
        return value.to(dtype=like.dtype, device=like.device)
    if isinstance(value, (int, float)):
        return torch.full((), float(value), dtype=like.dtype, device=like.device)
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def scale_matrix(value, position):
    """A scalar, (D,) vector or (D, D) matrix (None: the identity) as one
    (C, D, D) matrix per chain of the (C, D) ``position``; a (C, D, D) tensor
    is taken as is."""
    C, d = position.shape
    kw = dict(dtype=position.dtype, device=position.device)
    eye = torch.eye(d, **kw)
    if value is None:
        m = eye
    else:
        m = tensor_like(value, position)
        if m.dim() == 0:
            m = eye * m
        elif m.dim() == 1:
            m = torch.diag(m)
    return m.expand(C, d, d).contiguous()


def cholesky_or_nan(a):
    """Lower Cholesky factor of each (..., D, D) matrix of the batch, from its
    symmetric part; a matrix that is not positive definite gets a factor of
    NaN and the others are unaffected.  No status is read back to the host
    (``torch.linalg.cholesky`` raises on failure, and on CUDA synchronises
    every call to learn of it)."""
    factor, info = torch.linalg.cholesky_ex(0.5 * (a + a.mT), check_errors=False)
    return torch.where((info != 0)[..., None, None], torch.nan, factor)


def inverse_or_nan(a):
    """Inverse of each (..., D, D) matrix; a singular one becomes NaN, with
    no status read back to the host."""
    inv, info = torch.linalg.inv_ex(a, check_errors=False)
    return torch.where((info != 0)[..., None, None], torch.nan, inv)


def per_chain_step(step, C, dtype, device):
    """A step size as a (C,) tensor: a tensor (per chain, or one that
    broadcasts to (C,)) is taken as is, a number is filled."""
    if torch.is_tensor(step):
        return step.to(dtype=dtype, device=device).expand(C)
    return torch.full((C,), float(step), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base class. Subclasses define ``init`` and ``step``."""

    def init(self, target, position, generator=None, step_size=None, tuner=None, stream=None):
        raise NotImplementedError

    def step(self, state, target, generator=None, stream=None):
        raise NotImplementedError

    # statistic the tuner consumes: 'accept' (0/1) or 'accept_stat'
    tuner_statistic = "accept"
    # samplers with built-in adaptation make the job skip the tuner update
    self_tuning = False

    def keyed_sites(self, position) -> int:
        """The site offsets a step of the (C, ...) ``position`` draws at:
        the size its window must have."""
        return FIXED_SITES

    def default_tuner(self) -> Tuner:
        return VanillaTuner()

    def bind_tuner(self, tuner: Tuner) -> "Sampler":
        """Specialise the static config to the tuner in use."""
        return self
