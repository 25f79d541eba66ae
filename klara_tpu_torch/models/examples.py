"""Ready-made example targets and models (counterpart of
klara_tpu/models/examples.py).

The synthetic logistic regression draws its data with the same numpy
``default_rng(seed)`` code as the JAX package, so both packages see
bit-identical X and y.  The logreg target's batched value+grad is kernel K1
(``klara_tpu_torch.ops.logreg_value_grad``).  The rats model's full
conditionals are written batch-first: a per-chain scalar meets a per-rat
vector through an explicit ``[:, None]``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.core.target import Target
from klara_tpu_torch.data import dataset
from klara_tpu_torch.distributions import InverseGamma, Normal
from klara_tpu_torch.models.graph import Data, GenericModel, GibbsParameter
from klara_tpu_torch.ops.logreg import _softplus, logreg_value_grad, prepare_x


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

    Value and gradient come from one K1 launch per batch of chains (wider
    than K1's 128-column tile, its wide form); ``analytical_grad`` gives
    ``grad`` its closed form (else autograd).  The target lives on
    ``device`` (None: the device of X and y if they are tensors, else the
    card)."""
    device = resolve_device(device, (X, y))
    X = torch.as_tensor(X, dtype=torch.float32, device=device).contiguous()
    y = torch.as_tensor(y, dtype=torch.float32, device=X.device)
    d = X.shape[1]
    lam = float(prior_var)
    v = (X.T @ y).contiguous()  # Xᵀy, computed once
    # what K1 wants of X (padding, TF32 split, transposed copy) and y, made once
    prepared = prepare_x(X, y) if X.device.type == "cuda" else None

    def loglikelihood(P):
        logits = P @ X.T
        return logits @ y - _softplus(logits).sum(-1)

    def logprior(P):
        return -0.5 * ((P * P).sum(-1) / lam + d * math.log(2.0 * math.pi * lam))

    def grad(P):
        return v - torch.sigmoid(P @ X.T) @ X - P / lam

    def value_and_grad(P):
        return logreg_value_grad(P.contiguous(), X, v, lam, prepared=prepared)

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
    device = resolve_device(device)
    X = np.asarray(dataset("swiss", "measurements"), np.float64)
    y = np.asarray(dataset("swiss", "status"), np.float64)
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
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)).astype(np.float32)
    w = rng.standard_normal(dim).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-X @ w))
    y = (rng.random(n_data) < probs).astype(np.float32)
    target = logistic_regression_target(X, y, prior_var, device=device)
    Xt = torch.as_tensor(X, device=device)
    yt = torch.as_tensor(y, device=device)
    return target.with_name(f"logreg{dim}d"), Xt, yt


# ---------------------------------------------------------------------------
# Rats hierarchical growth model (BUGS classic)
# ---------------------------------------------------------------------------
#
#   Y_ij ~ N(alpha_i + beta_i (x_j − x̄), sigma_c²)   i=1..30 rats, j=1..5 ages
#   alpha_i ~ N(alpha_c, sigma_a²),  beta_i ~ N(beta_c, sigma_b²)
#   alpha_c, beta_c ~ N(0, 1e4²);  sigma² ~ InverseGamma(1e-3, 1e-3)
#
# All full conditionals are conjugate -> pure Gibbs sweep.


def rats_data(device=None):
    device = resolve_device(device)
    age = np.asarray(dataset("rats", "age"), np.float32)          # (5,)
    weight = np.asarray(dataset("rats", "weight"), np.float32)    # (30, 5)
    xc = torch.as_tensor(age - float(age.mean()), device=device)  # centred ages
    return xc, torch.as_tensor(weight, device=device)


def rats_gibbs_model(device=None, nested_alpha=False):
    """Conjugate Gibbs model for the rats data, batch-first: alpha and beta
    are (C, 30), the hyperparameters (C,).  Returns (model, v0) ready for
    ``GibbsJob(model, {}, ...)``.

    With ``nested_alpha`` the ``alpha`` vertex carries its conditional as a
    ``logtarget`` instead of a ``setpdf``, for an MCMC-within-Gibbs block
    (``GibbsJob(model, {"alpha": Nested(...)}, ...)``); every other vertex
    is the same."""
    device = resolve_device(device)
    xc, Y = rats_data(device)
    n_rats, n_ages = Y.shape
    sxx = float(torch.square(xc).sum())
    a0 = b0 = 1e-3    # InverseGamma prior
    prior_prec_c = 1e-8  # N(0, 1e4^2) on alpha_c / beta_c

    def alpha_cond(v):
        s2c, s2a = v["sigma2_c"][:, None], v["sigma2_a"][:, None]
        prec = n_ages / s2c + 1.0 / s2a
        mean = (
            (Y - v["beta"][..., None] * xc).sum(-1) / s2c
            + v["alpha_c"][:, None] / s2a
        ) / prec
        return Normal(mean, torch.sqrt(1.0 / prec))

    def alpha_logtarget(x, v):
        resid = Y - x[..., None] - v["beta"][..., None] * xc
        return (
            -0.5 * torch.square(resid).sum((-2, -1)) / v["sigma2_c"]
            - 0.5 * torch.square(x - v["alpha_c"][:, None]).sum(-1) / v["sigma2_a"]
        )

    def beta_cond(v):
        s2c, s2b = v["sigma2_c"][:, None], v["sigma2_b"][:, None]
        prec = sxx / s2c + 1.0 / s2b
        mean = (
            (Y - v["alpha"][..., None]) @ xc / s2c
            + v["beta_c"][:, None] / s2b
        ) / prec
        return Normal(mean, torch.sqrt(1.0 / prec))

    def alpha_c_cond(v):
        prec = n_rats / v["sigma2_a"] + prior_prec_c
        mean = v["alpha"].sum(-1) / v["sigma2_a"] / prec
        return Normal(mean, torch.sqrt(1.0 / prec))

    def beta_c_cond(v):
        prec = n_rats / v["sigma2_b"] + prior_prec_c
        mean = v["beta"].sum(-1) / v["sigma2_b"] / prec
        return Normal(mean, torch.sqrt(1.0 / prec))

    def sigma2_c_cond(v):
        resid = Y - v["alpha"][..., None] - v["beta"][..., None] * xc
        return InverseGamma(
            shape=a0 + 0.5 * n_rats * n_ages,
            scale=b0 + 0.5 * torch.square(resid).sum((-2, -1)),
        )

    def sigma2_a_cond(v):
        return InverseGamma(
            shape=a0 + 0.5 * n_rats,
            scale=b0 + 0.5 * torch.square(v["alpha"] - v["alpha_c"][:, None]).sum(-1),
        )

    def sigma2_b_cond(v):
        return InverseGamma(
            shape=a0 + 0.5 * n_rats,
            scale=b0 + 0.5 * torch.square(v["beta"] - v["beta_c"][:, None]).sum(-1),
        )

    model = GenericModel(
        [
            Data("Y"),
            Data("x"),
            GibbsParameter("alpha", logtarget=alpha_logtarget)
            if nested_alpha
            else GibbsParameter("alpha", setpdf=alpha_cond),
            GibbsParameter("beta", setpdf=beta_cond),
            GibbsParameter("alpha_c", setpdf=alpha_c_cond),
            GibbsParameter("beta_c", setpdf=beta_c_cond),
            GibbsParameter("sigma2_c", setpdf=sigma2_c_cond),
            GibbsParameter("sigma2_a", setpdf=sigma2_a_cond),
            GibbsParameter("sigma2_b", setpdf=sigma2_b_cond),
        ]
    )
    kw = dict(dtype=torch.float32, device=device)
    v0 = {
        "Y": Y,
        "x": xc,
        "alpha": torch.full((n_rats,), 250.0, **kw),
        "beta": torch.full((n_rats,), 6.0, **kw),
        "alpha_c": torch.tensor(150.0, **kw),
        "beta_c": torch.tensor(10.0, **kw),
        "sigma2_c": torch.tensor(1.0, **kw),
        "sigma2_a": torch.tensor(1.0, **kw),
        "sigma2_b": torch.tensor(1.0, **kw),
    }
    return model, v0


def rats_joint_target(device=None):
    """Joint 65-dim differentiable rats model for HMC/NUTS, log-variance
    parameterisation with its Jacobians; positions (C, 65) laid out as
    [alpha(30), beta(30), alpha_c, beta_c, log sigma2_c, log sigma2_a,
    log sigma2_b].  Returns (target, dim, unpack)."""
    xc, Y = rats_data(device)
    n_rats, n_ages = Y.shape
    a0 = b0 = 1e-3
    dim = 2 * n_rats + 5

    def unpack(p):
        return dict(
            alpha=p[:, :n_rats],
            beta=p[:, n_rats : 2 * n_rats],
            alpha_c=p[:, 2 * n_rats],
            beta_c=p[:, 2 * n_rats + 1],
            log_s2_c=p[:, 2 * n_rats + 2],
            log_s2_a=p[:, 2 * n_rats + 3],
            log_s2_b=p[:, 2 * n_rats + 4],
        )

    def logdensity(p):
        q = unpack(p)
        s2c, s2a, s2b = (torch.exp(q[k]) for k in ("log_s2_c", "log_s2_a", "log_s2_b"))
        mu = q["alpha"][..., None] + q["beta"][..., None] * xc
        ll = -0.5 * torch.square(Y - mu).sum((-2, -1)) / s2c - 0.5 * n_rats * n_ages * q["log_s2_c"]
        lp_a = (-0.5 * torch.square(q["alpha"] - q["alpha_c"][:, None]).sum(-1) / s2a
                - 0.5 * n_rats * q["log_s2_a"])
        lp_b = (-0.5 * torch.square(q["beta"] - q["beta_c"][:, None]).sum(-1) / s2b
                - 0.5 * n_rats * q["log_s2_b"])
        lp_c = -0.5e-8 * (torch.square(q["alpha_c"]) + torch.square(q["beta_c"]))
        # InverseGamma(a0, b0) on sigma2 with log-jacobian: +log s2
        lp_s = sum(
            -(a0 + 1.0) * ls - b0 / s2 + ls
            for ls, s2 in [
                (q["log_s2_c"], s2c),
                (q["log_s2_a"], s2a),
                (q["log_s2_b"], s2b),
            ]
        )
        return ll + lp_a + lp_b + lp_c + lp_s

    return Target(logdensity_fn=logdensity, dim=dim).with_name("rats_joint"), dim, unpack
