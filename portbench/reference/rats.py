"""Plain reference of the rats model's conjugate Gibbs sweep (BUGS "Rats":
Gelfand, Hills, Racine-Poon & Smith, JASA 1990), replayed chain by chain
from the start values with draws regenerated from the run key.  Imports
nothing of the program.

    Y_ij ~ N(alpha_i + beta_i (x_j − x̄), sigma2_c),  i = 1..30, j = 1..5
    alpha_i ~ N(alpha_c, sigma2_a),  beta_i ~ N(beta_c, sigma2_b)
    alpha_c, beta_c ~ N(0, 1e4²),  sigma2_* ~ InverseGamma(1e-3, 1e-3)

One sweep updates seven blocks in this order, block b drawing at site b of
sweep i's counter: alpha (a normal a rat), beta (the same), alpha_c,
beta_c (one normal each), sigma2_c, sigma2_a, sigma2_b (scale over one
standard gamma each).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import philox as P

BLOCKS = ("alpha", "beta", "alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")
A0 = B0 = 1e-3
PRIOR_PREC_C = 1e-8


def data(config, device):
    """(centred ages (5,), weights (30, 5)) from the configuration, in f32 as
    the data file holds them, moved to ``device`` in float64."""
    age = np.asarray(config["data"]["age"], np.float32)
    weight = np.asarray(config["data"]["weight"], np.float32)
    xc = age - np.float32(age.mean())
    return (torch.as_tensor(xc, dtype=torch.float64, device=device),
            torch.as_tensor(weight, dtype=torch.float64, device=device))


def gamma_shapes(n_rats: int, n_ages: int):
    """The standard gammas' shapes of blocks 4-6, as the f32 parameters."""
    return tuple(float(np.float32(A0 + 0.5 * n)) for n in (n_rats * n_ages, n_rats, n_rats))


def draws(key: int, chains, sweeps: int, n_rats: int, n_ages: int, device, gamma_tol: float):
    """Every draw of ``sweeps`` sweeps of the ``chains`` (S,): normals
    (sweeps, S, n_rats) of blocks 0-1 and (sweeps, S) of blocks 2-3,
    standard gammas (sweeps, S) of blocks 4-6, and (sweeps, S) flags of the
    gamma draws whose accept test came within ``gamma_tol`` of a boundary."""
    c = chains.to(device=device, dtype=torch.int64)
    steps = torch.arange(sweeps, dtype=torch.int64, device=device)
    elems = torch.arange(n_rats, dtype=torch.int64, device=device)
    out = {}
    for b in (0, 1):
        w = P.words(key, c[None, :, None], steps[:, None, None], b, elems[None, None, :])
        out[b] = P.normal(w[0], w[1])
    for b in (2, 3):
        w = P.words(key, c[None, :], steps[:, None], b, 0)
        out[b] = P.normal(w[0], w[1])
    ambiguous = torch.zeros((sweeps, c.shape[0]), dtype=torch.bool, device=device)
    for b, alpha in zip((4, 5, 6), gamma_shapes(n_rats, n_ages)):
        out[b], amb = P.standard_gamma(key, c[None, :], steps[:, None], b, alpha, gamma_tol)
        ambiguous |= amb
    return out, ambiguous


def replay(start, noise, xc, Y, keep_from: int, dtype=torch.float64, device="cpu"):
    """The sweeps of the chains whose draws are ``noise`` (``draws``), from
    the ``start`` values {block: scalar}, in ``dtype``: the five
    hyperparameters of every sweep from ``keep_from`` on, {name: (kept, S)}.
    float64 runs in NumPy on the host (a sweep is some fifty small
    operations), any other dtype in torch on ``device``."""
    sweeps, S = noise[2].shape
    n_rats, n_ages = Y.shape
    if dtype == torch.float64:
        def arr(t):
            return t.detach().cpu().numpy()

        def full(shape, value):
            return np.full(shape, value, dtype=np.float64)
    else:
        def arr(t):
            return t.detach().to(device=device, dtype=dtype)

        def full(shape, value):
            return torch.full(shape, value, dtype=dtype, device=device)
    xc, Y = arr(xc), arr(Y)
    sxx = (xc * xc).sum()
    v = {k: full((S, n_rats) if k in ("alpha", "beta") else (S,), float(start[k]))
         for k in BLOCKS}
    z = {b: arr(noise[b]) for b in noise}
    kept = {k: full((sweeps - keep_from, S), 0.0) for k in BLOCKS[2:]}
    for i in range(sweeps):
        s2c, s2a, s2b = v["sigma2_c"][:, None], v["sigma2_a"][:, None], v["sigma2_b"][:, None]
        prec = n_ages / s2c + 1.0 / s2a
        mean = ((Y - v["beta"][..., None] * xc).sum(-1) / s2c + v["alpha_c"][:, None] / s2a) / prec
        v["alpha"] = mean + (1.0 / prec) ** 0.5 * z[0][i]
        prec = sxx / s2c + 1.0 / s2b
        mean = ((Y - v["alpha"][..., None]) @ xc / s2c + v["beta_c"][:, None] / s2b) / prec
        v["beta"] = mean + (1.0 / prec) ** 0.5 * z[1][i]
        prec = n_rats / v["sigma2_a"] + PRIOR_PREC_C
        v["alpha_c"] = v["alpha"].sum(-1) / v["sigma2_a"] / prec + (1.0 / prec) ** 0.5 * z[2][i]
        prec = n_rats / v["sigma2_b"] + PRIOR_PREC_C
        v["beta_c"] = v["beta"].sum(-1) / v["sigma2_b"] / prec + (1.0 / prec) ** 0.5 * z[3][i]
        resid = Y - v["alpha"][..., None] - v["beta"][..., None] * xc
        v["sigma2_c"] = (B0 + 0.5 * (resid * resid).sum((-2, -1))) / z[4][i]
        da = v["alpha"] - v["alpha_c"][:, None]
        v["sigma2_a"] = (B0 + 0.5 * (da * da).sum(-1)) / z[5][i]
        db = v["beta"] - v["beta_c"][:, None]
        v["sigma2_b"] = (B0 + 0.5 * (db * db).sum(-1)) / z[6][i]
        if i >= keep_from:
            for k in kept:
                kept[k][i - keep_from] = v[k]
    return {k: torch.as_tensor(x).cpu() for k, x in kept.items()}


def trace_gap(saved, ref, ambiguous, keep_from: int, exclude: int):
    """The widest gap |saved − ref| over the saved sweeps of the five
    hyperparameters ({name: (kept, S)} each), in units of the reference's
    spread of that hyperparameter (its standard deviation over the judged
    sweeps and chains), leaving out each chain's ``exclude`` sweeps after a
    gamma draw the reference calls ambiguous (``ambiguous``: (sweeps, S)); a
    non-finite saved value reads inf.  Returns (gap, values left out)."""
    sweeps, S = ambiguous.shape
    hit = ambiguous.to(torch.float64).cpu()
    # a sweep is left out when an ambiguous draw lies in the ``exclude`` sweeps up to it
    csum = torch.cat([torch.zeros(1, S, dtype=torch.float64), hit.cumsum(0)])
    lo = torch.clamp(torch.arange(sweeps) - exclude + 1, min=0)
    recent = csum[torch.arange(sweeps) + 1] - csum[lo]
    judged = (recent == 0)[keep_from:]
    worst = 0.0
    for k, r in ref.items():
        s = saved[k].to(torch.float64).cpu()
        r = r.to(torch.float64).cpu()
        sd = float(r[judged].std())
        gap = torch.where(torch.isfinite(s), (s - r).abs() / sd, torch.full_like(s, np.inf))
        gap = torch.where(judged, gap, torch.zeros_like(gap))
        worst = max(worst, float(gap.max()))
    return worst, int((~judged).sum())
