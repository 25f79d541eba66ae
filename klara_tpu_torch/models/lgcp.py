"""The log-Gaussian Cox process on an n × n grid, sampled non-centred.

Møller, Syversveen & Waagepetersen, Scand. J. Stat. 25 (1998); the
high-dimensional HMC example of Girolami & Calderhead, JRSS-B 73 (2011)
123-214.  Cells (i, j) of an n × n grid over the unit square, D = n², each
of area m = 1/D (row-major: cell (i, j) is coordinate i·n + j); a latent
field x ~ N(μ1, Σ) with Σ_(ij),(i'j') = σ²·exp(−δ/(nβ)), δ the distance
between the cells in grid units; counts y_ij ~ Poisson(m·exp(x_ij)).

Sampled non-centred, x = μ + L z with L the Cholesky factor of Σ and
z ~ N(0, I), so that, row-wise for a (C, D) batch (x = μ + z Lᵀ),

    log p(z | y) = Σ y·x − m·Σ exp(x) − ½‖z‖²   (constants dropped)
    ∇_z          = (y − m·e^x) L − z

One evaluation is two (C, D)×(D, D) products around an exp, the products
``core.target.through_factor``'s (as ``whiten_target``'s): no solve and no
autograd.  Σ and its factor are made once per target in float64 (NumPy),
the factor kept in float32; the value+grad is float32 throughout.

Every evaluation counts as ``through_factor``'s do: one in
``core.target.FACTOR_EVALUATIONS`` (replay-aware: eager, captured and
replayed evaluations total the eager loop's) and its host time in the
tracer's ``factor.host_ns``, a span ``factor`` while recording.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from klara_tpu_torch.core.device import resolve_device
from klara_tpu_torch.core.target import Target, through_factor
from klara_tpu_torch.distributions import Normal

SIGMA2 = 1.91        # the field's variance
BETA = 1.0 / 33.0    # its correlation scale, in units of the square's side
EXPECTED_POINTS = 126.0


def default_mean(sigma2: float = SIGMA2) -> float:
    """μ = log(126) − σ²/2: the field's mean that puts the pines' 126 points
    in the unit square in expectation."""
    return math.log(EXPECTED_POINTS) - 0.5 * sigma2


def grid_covariance(n: int, sigma2: float = SIGMA2, beta: float = BETA) -> np.ndarray:
    """Σ (n², n²) in float64: σ²·exp(−δ/(nβ)) between every two cells."""
    i, j = np.divmod(np.arange(n * n, dtype=np.float64), n)
    delta = np.hypot(i[:, None] - i[None, :], j[:, None] - j[None, :])
    return sigma2 * np.exp(-delta / (n * beta))


def grid_factor(n: int, sigma2: float = SIGMA2, beta: float = BETA) -> np.ndarray:
    """The lower Cholesky factor L of ``grid_covariance``, float64."""
    return np.linalg.cholesky(grid_covariance(n, sigma2, beta))


def synthetic_counts(chol: np.ndarray, mean: float, seed: int) -> np.ndarray:
    """Counts (D,) float32 drawn from the model with NumPy's
    ``default_rng(seed)``: a field x* = μ + L ε, ε ~ N(0, I), then
    y ~ Poisson(m·e^{x*})."""
    d = chol.shape[0]
    rng = np.random.default_rng(seed)
    field = mean + chol @ rng.standard_normal(d)
    return rng.poisson(np.exp(field) / d).astype(np.float32)


def lgcp_target(counts, chol, mean: float, device=None) -> Target:
    """The non-centred LGCP posterior in z for ``counts`` (D,) under the
    factor ``chol`` (D, D) of the field's covariance and its ``mean``, in
    float32 on ``device`` (None: the device of the tensors given, else the
    card).  Its prior, N(0, I), gives a job's starts."""
    device = resolve_device(device, (counts, chol))
    y = torch.as_tensor(counts, dtype=torch.float32, device=device).contiguous()
    chol = torch.as_tensor(chol, dtype=torch.float32, device=device).contiguous()
    d = y.shape[0]
    if chol.shape != (d, d):
        raise ValueError(f"lgcp: counts are ({d},), the factor {tuple(chol.shape)}")
    m = 1.0 / d
    shift = torch.full((d,), float(mean), dtype=torch.float32, device=device)

    def poisson(x):
        e = torch.exp(x)
        return x @ y - m * e.sum(-1), torch.add(y, e, alpha=-m)

    value_and_grad, to_x = through_factor(poisson, chol, shift, standard_normal=True)

    def loglikelihood(z):
        x = to_x(z)
        return x @ y - m * torch.exp(x).sum(-1)

    def logprior(z):
        return -0.5 * (z * z).sum(-1)

    return Target.from_loglik_logprior(
        loglikelihood, logprior, dim=d, value_and_grad_fn=value_and_grad,
        prior=Normal(0.0, 1.0),
    ).with_name(f"lgcp{d}")


def lgcp_grid(n: int = 64, sigma2: float = SIGMA2, beta: float = BETA, mean=None,
              seed: int = 0, device=None):
    """The LGCP on an n × n grid with synthetic counts (``synthetic_counts``
    from ``seed``).  Returns (target, counts (D,), factor L (D, D) float32),
    the tensors on the target's device."""
    device = resolve_device(device)
    mean = default_mean(sigma2) if mean is None else float(mean)
    chol = grid_factor(n, sigma2, beta)
    counts = synthetic_counts(chol, mean, seed)
    chol_t = torch.as_tensor(chol, device=device).to(torch.float32)
    counts_t = torch.as_tensor(counts, device=device)
    return lgcp_target(counts_t, chol_t, mean, device), counts_t, chol_t
