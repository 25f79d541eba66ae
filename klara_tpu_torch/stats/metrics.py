"""Riemannian-metric utilities (counterpart of klara_tpu/stats/metrics.py)."""

from __future__ import annotations

import torch


def softabs(hessian, a: float = 1000.0):
    """Q · diag(λ / tanh(a·λ)) · Qᵀ of a symmetric (..., D, D) matrix: a
    smooth |λ| with minimum 1/a (Betancourt 2013), the positive-definite
    projection SMMALA applies to an indefinite Hessian."""
    lam, q = torch.linalg.eigh(hessian)
    smoothed = lam / torch.tanh(a * lam)
    # the λ → 0 limit is 1/a
    smoothed = torch.where(lam.abs() < 1e-10, 1.0 / a, smoothed)
    return (q * smoothed.unsqueeze(-2)) @ q.transpose(-1, -2)
