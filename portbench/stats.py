"""The benchmark's frozen scoring arithmetic: ESS and rank-R̂.

A copy of the arithmetic the port's ``stats`` package uses (Geyer's initial
monotone sequence over an FFT autocovariance, chain-summed ESS; Vehtari et
al.'s rank-normalised split-R̂), kept here so that no change to the program
moves the yardstick.  Plain torch; every function reduces along dim 0
(draws) of an (n_draws, n_chains, ...) tensor.
"""

from __future__ import annotations

import torch

RHAT_GATE = 1.02  # a job mixes when its worst rank-R̂ is at most this


def autocov(x):
    """Autocovariances γ₀..γ_{n−1} along dim 0, denominator n."""
    n = x.shape[0]
    xc = x - x.mean(0, keepdim=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    return torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:n] / n


def mcvar_imse(x):
    """Geyer's initial monotone sequence estimate of the variance of the mean."""
    n = x.shape[0]
    k = (n - 2) // 2
    acv = autocov(x)
    g = acv[0:2 * k + 1:2] + acv[1:2 * k + 2:2]
    lead = torch.cumprod((g > 0).to(x.dtype), dim=0)
    g = torch.cummin(g, dim=0).values
    return (-acv[0] + 2.0 * (g * lead).sum(0)) / n


def ess(x):
    """Chain-summed ESS of an (n_draws, n_chains, ...) f32 trace: (...)."""
    e = x.shape[0] * (torch.var(x, dim=0, correction=1) / x.shape[0]) / mcvar_imse(x)
    return e.sum(0)


def ess_chunk(n_draws: int, dim: int) -> int:
    """Chains per chunk so that one chunk's FFT holds about 2^28 values."""
    nfft = 1
    while nfft < 2 * n_draws:
        nfft *= 2
    return min(2048, max(128, (1 << 28) // (nfft * dim)))


def min_ess(values, chol=None):
    """Min over coordinates of the chain-summed ESS of a (draws, chains, D)
    trace, mapped to x = y Lᵀ (L = ``chol``; None: as stored) one chunk of
    chains at a time, in f32."""
    chunk = ess_chunk(values.shape[0], values.shape[-1])
    total = 0.0
    for s in range(0, values.shape[1], chunk):
        x = values[:, s:s + chunk].to(torch.float32)
        if chol is not None:
            x = x @ chol.T.to(torch.float32)
        total = total + ess(x)
    return float(torch.as_tensor(total).min())


def split_rhat(x):
    n = x.shape[0] // 2 * 2
    half = n // 2
    split = torch.cat([x[:half], x[half:n]], dim=1)
    means, var = split.mean(0), torch.var(split, dim=0, correction=1)
    w = var.mean(0)
    b = half * torch.var(means, dim=0, correction=1)
    return torch.sqrt(((half - 1) / half * w + b / half) / w)


def _rank_normalize(x):
    shape = x.shape
    cols = x.reshape(shape[0] * shape[1], -1).T.contiguous()
    s = torch.sort(cols, dim=-1).values
    lo = torch.searchsorted(s, cols, side="left")
    hi = torch.searchsorted(s, cols, side="right")
    ranks = (lo + hi + 1).to(torch.float32) / 2.0
    z = torch.special.ndtri((ranks - 0.375) / (cols.shape[1] + 0.25))
    return z.T.reshape(shape)


def rhat_rank(x):
    """Rank-normalised split-R̂: the larger of bulk and tail, per coordinate."""
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    s = torch.sort(flat, dim=0).values
    med = (s[(s.shape[0] - 1) // 2] + s[s.shape[0] // 2]) * 0.5
    bulk = split_rhat(_rank_normalize(x))
    tail = split_rhat(_rank_normalize(torch.abs(x - med)))
    return torch.maximum(bulk, tail)


def max_rhat(values, chol=None, max_draws=512, chains_cap=2048, dim_chunk=16):
    """Max over coordinates of rank-R̂ on up to ``max_draws`` evenly thinned
    draws of the first ``chains_cap`` chains, mapped through ``chol`` a
    chunk of coordinates at a time."""
    values = values[:, :chains_cap]
    step = max(1, values.shape[0] // max_draws)
    y = values[::step].to(torch.float32)
    if chol is None:
        return float(rhat_rank(y).max())
    chol = chol.to(torch.float32)
    return max(float(rhat_rank(y @ chol[s:s + dim_chunk].T).max())
               for s in range(0, values.shape[-1], dim_chunk))
