"""Ready-made example targets (counterpart of klara_tpu/models/examples.py).

The synthetic logistic regression draws its data with the same numpy
``default_rng(seed)`` code as the JAX package, so both packages see
bit-identical X and y.  The logreg target's batched value+grad is kernel K1
(``klara_tpu_torch.ops.logreg_value_grad``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from klara_tpu_torch.core.target import Target
from klara_tpu_torch.ops.logreg import _softplus, logreg_value_grad

# the swiss banknote data ships with the JAX package; it is read from there
SWISS_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "klara_tpu", "data", "files", "swiss.npz",
)


def normal_target(dim: int = 2) -> Target:
    """p(x) ∝ exp(−½‖x‖²), the README example's unnormalised normal."""
    return Target(
        logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=dim
    ).with_name(f"normal{dim}d")


def logistic_regression_target(
    X, y, prior_var: float = 100.0, analytical_grad: bool = True, device=None,
) -> Target:
    """Bayesian logistic regression with a N(0, prior_var·I) prior, in f32:
    loglik(p) = (Xp)ᵀy − Σ softplus(Xp), logprior(p) = −½(pᵀp/λ + d·log 2πλ).

    Value and gradient come from one K1 launch per batch of chains;
    ``analytical_grad`` gives ``grad`` its closed form (else autograd)."""
    X = torch.as_tensor(X, dtype=torch.float32, device=device).contiguous()
    y = torch.as_tensor(y, dtype=torch.float32, device=X.device)
    d = X.shape[1]
    lam = float(prior_var)
    v = (X.T @ y).contiguous()  # Xᵀy, computed once

    def loglikelihood(P):
        logits = P @ X.T
        return logits @ y - _softplus(logits).sum(-1)

    def logprior(P):
        return -0.5 * ((P * P).sum(-1) / lam + d * math.log(2.0 * math.pi * lam))

    def grad(P):
        return v - torch.sigmoid(P @ X.T) @ X - P / lam

    def value_and_grad(P):
        return logreg_value_grad(P.contiguous(), X, v, lam)

    return Target.from_loglik_logprior(
        loglikelihood,
        logprior,
        dim=d,
        grad_fn=grad if analytical_grad else None,
        value_and_grad_fn=value_and_grad,
    ).with_name("logreg")


def swiss_logistic_regression(prior_var: float = 100.0, analytical_grad: bool = True,
                              device=None):
    """The swiss-banknote workload (200×4, standardised covariates).
    Returns (target, X, y)."""
    with np.load(SWISS_NPZ) as z:
        X = np.asarray(z["measurements"], np.float64)
        y = np.asarray(z["status"], np.float64)
    X = (X - X.mean(axis=0)) / X.std(axis=0, ddof=1)
    target = logistic_regression_target(
        X, y, prior_var, analytical_grad, device=device
    )
    Xt = torch.as_tensor(X, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)
    return target.with_name("swiss"), Xt, yt


def synthetic_logistic_regression(
    dim: int = 100, n_data: int = 1000, prior_var: float = 100.0, seed: int = 0,
    device=None,
):
    """D-dim logistic regression: covariates ~ N(0, I), true weights ~ N(0, 1),
    labels Bernoulli(σ(Xw)).  Returns (target, X, y)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)).astype(np.float32)
    w = rng.standard_normal(dim).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-X @ w))
    y = (rng.random(n_data) < probs).astype(np.float32)
    target = logistic_regression_target(X, y, prior_var, device=device)
    Xt = torch.as_tensor(X, device=device)
    yt = torch.as_tensor(y, device=device)
    return target.with_name(f"logreg{dim}d"), Xt, yt
