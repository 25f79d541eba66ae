"""Recursive empirical covariance by rank-1 updates (counterpart of
klara_tpu/stats/covariance.py), batch-first:

    C_k = ((k−1)·C_{k−1} + x xᵀ − (k+1)·m̄ m̄ᵀ + k·m̄₂ m̄₂ᵀ) / k

with m̄ the running mean after x and m̄₂ the one before.  ``x`` is (C, D) and
the covariance (C, D, D), one per chain; a (C,) ``x`` takes the scalar
recursion.  ``k`` is a number or a per-chain (C,) tensor, k >= 1.
"""

from __future__ import annotations

import torch


def _outer(a):
    return a.unsqueeze(-1) * a.unsqueeze(-2)


def recursive_covariance(last_cov, k, x, lastmean, secondlastmean):
    kf = torch.as_tensor(k, device=x.device).to(x.dtype)
    if x.dim() == 1:
        return (
            (kf - 1.0) * last_cov
            + torch.square(x)
            - (kf + 1.0) * torch.square(lastmean)
            + kf * torch.square(secondlastmean)
        ) / kf
    if kf.dim() == 1:
        kf = kf[:, None, None]
    return (
        (kf - 1.0) * last_cov
        + _outer(x)
        - (kf + 1.0) * _outer(lastmean)
        + kf * _outer(secondlastmean)
    ) / kf
