"""Monte Carlo variance / standard error estimators (counterpart of
klara_tpu/stats/mcvar.py): ``iid``, ``bm`` (batch means), ``imse`` (Geyer
initial monotone sequence, the default) and ``ipse`` (initial positive
sequence).  Autocovariances come from one batched real FFT; Geyer's
data-dependent cutoffs are mask arithmetic (cumprod, cummin).

All functions reduce along dim 0 (draws) and broadcast over the rest, so
they apply directly to (n_post, n_chains, dim) traces.  Memory: the FFT of
an (n, m, d) trace holds about 2·n·m·d complex64 values, so callers chunk
long many-chain traces over chains.
"""

from __future__ import annotations

import torch

from klara_tpu_torch.parallel.mesh import sum_over_ranks
from klara_tpu_torch.stats._common import chain_scope, extract_f32, gather_results


def autocov(x, maxlag=None):
    """Empirical autocovariances [γ₀..γ_maxlag] along dim 0, denominator n."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if maxlag is None:
        maxlag = n - 1
    xc = x - x.mean(0, keepdim=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    acf = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[: maxlag + 1]
    return acf / n


def mcvar_iid(x):
    """var(v)/n with Bessel correction."""
    x = torch.as_tensor(x)
    return torch.var(x, dim=0, correction=1) / x.shape[0]


def mcvar_bm(x, batchlen: int = 100):
    """Batch-means estimator."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    nbatches = n // batchlen
    if nbatches <= 1:
        raise ValueError("batchlen leaves fewer than 2 batches")
    nbsamples = nbatches * batchlen
    bm = x[:nbsamples].reshape((nbatches, batchlen) + tuple(x.shape[1:])).mean(1)
    return batchlen * torch.var(bm, dim=0, correction=1) / nbsamples


def _initial_sequence(x, monotone: bool):
    x = torch.as_tensor(x)
    n = x.shape[0]
    maxlag = n - 1
    k = (maxlag - 1) // 2
    acv = autocov(x, maxlag)
    # Γ̂_j = γ_{2j} + γ_{2j+1}, j = 0..k (Geyer 1992)
    g = acv[0 : 2 * k + 1 : 2] + acv[1 : 2 * k + 2 : 2]
    lead = torch.cumprod((g > 0).to(x.dtype), dim=0)  # 1 while every Γ̂ so far is positive
    if monotone:
        g = torch.cummin(g, dim=0).values
    total = (g * lead).sum(0)
    return (-acv[0] + 2.0 * total) / n


def mcvar_imse(x):
    """Geyer initial monotone sequence estimator."""
    return _initial_sequence(x, monotone=True)


def mcvar_ipse(x):
    """Geyer initial positive sequence estimator."""
    return _initial_sequence(x, monotone=False)


_ESTIMATORS = {
    "iid": mcvar_iid,
    "bm": mcvar_bm,
    "imse": mcvar_imse,
    "ipse": mcvar_ipse,
}


def mcvar(chain_or_array, estimator: str = "imse", field: str = "value", **kwargs):
    """MC variance of the chain mean along the draws axis, per chain; a
    meshed chain's is computed on the rank's chains and gathered."""
    x = extract_f32(chain_or_array, field)
    return gather_results(chain_or_array, x, _ESTIMATORS[estimator](x, **kwargs))


def mcse(chain_or_array, estimator: str = "imse", field: str = "value", **kwargs):
    """MC standard error = sqrt(mcvar)."""
    return torch.sqrt(mcvar(chain_or_array, estimator, field, **kwargs))


def ess(chain_or_array, estimator: str = "imse", field: str = "value",
        combine_chains: bool = True, **kwargs):
    """Effective sample size n·var_iid/var_mc, per chain; with
    ``combine_chains`` summed over the chain axis (dim 1).  A meshed chain's
    sum is all-reduced (per chain: gathered), so every rank gets the global
    value."""
    x = extract_f32(chain_or_array, field)
    e = x.shape[0] * mcvar_iid(x) / _ESTIMATORS[estimator](x, **kwargs)
    if x.dim() < 2 or not combine_chains:
        return gather_results(chain_or_array, x, e)
    with chain_scope(chain_or_array, x):
        return sum_over_ranks(e.sum(0))


def iact(chain_or_array, estimator: str = "imse", field: str = "value", **kwargs):
    """Integrated autocorrelation time var_mc/var_iid, per chain (a meshed
    chain's gathered)."""
    x = extract_f32(chain_or_array, field)
    return gather_results(chain_or_array, x, _ESTIMATORS[estimator](x, **kwargs) / mcvar_iid(x))
