"""Split-R̂ and rank-normalised diagnostics (counterpart of
klara_tpu/stats/rhat.py; Vehtari, Gelman, Simpson, Carpenter & Bürkner 2021).

Of a meshed chain, split-R̂ all-gathers each half-chain's mean and variance
(every half has the same length, so no length is gathered); the
rank-normalised statistics (``rhat_rank``, ``ess_bulk``, ``ess_tail``)
all-gather the draws, since a draw's global rank needs every draw.

Median and quantile are written on ``torch.sort``: ``torch.median`` returns
the lower middle value where ``jnp.median`` averages the two, and
``torch.quantile`` refuses inputs over 2^24 elements.
"""

from __future__ import annotations

import torch

from klara_tpu_torch.stats._common import extract_f32, gather_results
from klara_tpu_torch.stats.mcvar import ess


def rhat(chain_or_array, field: str = "value"):
    """Split-R̂ along (draws, chains); input (n, m, ...) -> output (...)."""
    x = extract_f32(chain_or_array, field)
    n = x.shape[0] // 2 * 2
    half = n // 2
    split = torch.cat([x[:half], x[half:n]], dim=1)
    # (2 stats, 2 halves, m chains, ...) -> every rank's chains on axis 2
    per_chain = torch.stack([split.mean(0), torch.var(split, dim=0, correction=1)])
    per_chain = per_chain.unflatten(1, (2, x.shape[1])).movedim(2, 0)
    per_chain = gather_results(chain_or_array, x, per_chain).movedim(0, 2).flatten(1, 2)
    chain_means, chain_vars = per_chain
    w = chain_vars.mean(0)
    b = half * torch.var(chain_means, dim=0, correction=1)
    var_plus = (half - 1) / half * w + b / half
    return torch.sqrt(var_plus / w)


def _median0(x):
    """Median along dim 0, the two middle values averaged (jnp.median)."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _quantile0(x, q: float):
    """Linear-interpolation quantile along dim 0 (jnp.quantile's default),
    with its f32 index arithmetic."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    lw = 1.0 - hw
    return s[int(lo)] * lw.to(s.device) + s[int(hi)] * hw.to(s.device)


def _rank_normalize(x):
    """Joint rank-normalisation over (draws, chains): average ranks, Blom
    offsets, standard-normal quantiles.  Average ranks keep ties (the
    indicator chains of tail-ESS) free of spurious order."""
    shape = x.shape
    cols = x.reshape(shape[0] * shape[1], -1).T.contiguous()  # (dims, n·m)
    s = torch.sort(cols, dim=-1).values
    lo = torch.searchsorted(s, cols, side="left")
    hi = torch.searchsorted(s, cols, side="right")
    ranks = (lo + hi + 1).to(torch.float32) / 2.0
    u = (ranks - 0.375) / (cols.shape[1] + 0.25)
    z = torch.special.ndtri(u)
    return z.T.reshape(shape)


def rhat_rank(chain_or_array, field: str = "value"):
    """Rank-normalised split-R̂: the max of bulk (rank-normalised) and tail
    (folded rank-normalised) split-R̂.  Input (n, m, ...) -> output (...)."""
    x = extract_f32(chain_or_array, field, gather=True)
    bulk = rhat(_rank_normalize(x))
    folded = torch.abs(x - _median0(x.reshape((-1,) + tuple(x.shape[2:]))))
    tail = rhat(_rank_normalize(folded))
    return torch.maximum(bulk, tail)


def ess_bulk(chain_or_array, field: str = "value", **kwargs):
    """Bulk-ESS: ESS of the rank-normalised draws."""
    return ess(_rank_normalize(extract_f32(chain_or_array, field, gather=True)), **kwargs)


def ess_tail(chain_or_array, field: str = "value", quantiles=(0.05, 0.95), **kwargs):
    """Tail-ESS: the minimum ESS of the rank-normalised indicator chains
    for the given tail quantiles."""
    x = extract_f32(chain_or_array, field, gather=True)
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    out = None
    for q in quantiles:
        ind = (x <= _quantile0(flat, q)).to(torch.float32)
        e = ess(_rank_normalize(ind), **kwargs)
        out = e if out is None else torch.minimum(out, e)
    return out
