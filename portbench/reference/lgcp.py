"""Plain reference of the log-Gaussian Cox process on an n × n grid and its
non-centred HMC transition, in float64 torch.  Imports nothing of the
program.

Model (Møller, Syversveen & Waagepetersen 1998; Girolami & Calderhead 2011):
cells (i, j), row-major coordinate i·n + j, D = n², area m = 1/D; a field
x = μ + L z, L the Cholesky factor of Σ_(ij),(i'j') = σ²·exp(−δ/(nβ)) (δ the
cells' distance in grid units), z ~ N(0, I); counts y ~ Poisson(m·e^x).
In z, row-wise for a (C, D) batch (x = μ + z Lᵀ):

    log p(z | y) = Σ y·x − m·Σ e^x − ½‖z‖²,   ∇_z = (y − m·e^x) L − z.

Departures from the paper, each the configuration's (``assumed``):
- the counts are synthetic, drawn from the model itself (a field from NumPy's
  ``default_rng(data_seed)``, then Poisson counts from the same generator),
  in place of the Finnish pines' 126 trees, which the repository does not
  hold; μ = log 126 − σ²/2 keeps their expected count;
- the constants σ² = 1.91, β = 1/33 are the paper's example's, fixed, not
  sampled;
- the density drops the constants −Σ log y! and the normal's normaliser;
- sampled non-centred with HMC under ChEES (Hoffman, Radul & Sountsov 2021),
  as many-chain users run it, where the paper compares MALA, HMC and their
  Riemannian forms.

The HMC replay reuses the target-agnostic pieces of ``reference.logreg``
(dual averaging, ChEES, the ensemble mass, leap counts, keyed momenta) and
``reference.philox``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import logreg as R
from portbench.reference import philox as P


def covariance(n: int, sigma2: float, beta: float, device=None):
    """Σ (n², n²) float64 from the cells' distance matrix."""
    idx = torch.arange(n * n, dtype=torch.float64, device=device)
    i, j = torch.div(idx, n, rounding_mode="floor"), torch.remainder(idx, n)
    delta = torch.sqrt((i[:, None] - i[None, :]) ** 2 + (j[:, None] - j[None, :]) ** 2)
    return sigma2 * torch.exp(-delta / (n * beta))


def factor(n: int, sigma2: float, beta: float, device=None):
    """The lower Cholesky factor of ``covariance``, float64."""
    return torch.linalg.cholesky(covariance(n, sigma2, beta, device))


def mean_of(config) -> float:
    """μ from the configuration: log(expected points) − σ²/2."""
    return math.log(config["expected_points"]) - 0.5 * config["sigma2"]


def synthetic_counts(n: int, sigma2: float, beta: float, mean: float, seed: int):
    """The configuration's data recipe, in NumPy float64: Σ and its factor,
    a field μ + L ε with ε the first n² normals of ``default_rng(seed)``,
    then Poisson counts of mean m·e^field from the same generator; float32."""
    i, j = np.divmod(np.arange(n * n, dtype=np.float64), n)
    sigma = sigma2 * np.exp(-np.sqrt((i[:, None] - i[None, :]) ** 2
                                     + (j[:, None] - j[None, :]) ** 2) / (n * beta))
    L = np.linalg.cholesky(sigma)
    rng = np.random.default_rng(seed)
    field = mean + L @ rng.standard_normal(n * n)
    return rng.poisson(np.exp(field) / (n * n)).astype(np.float32)


def value_grad(z, y, L, mean: float):
    """(log-density (C,), gradient (C, D)) at the (C, D) positions ``z``, in
    the dtype of the inputs."""
    m = 1.0 / y.shape[0]
    x = mean + z @ L.T
    e = torch.exp(x)
    value = x @ y - m * e.sum(-1) - 0.5 * (z * z).sum(-1)
    return value, (y - m * e) @ L - z


class Problem:
    """A configuration's target in float64 on ``device``: its factor, counts
    and mean, and ``vg(z)``, the value and gradient."""

    def __init__(self, config, device):
        n, s2, beta = config["grid"], config["sigma2"], config["beta"]
        self.mean = mean_of(config)
        self.L = factor(n, s2, beta, device)
        self.y = torch.as_tensor(synthetic_counts(n, s2, beta, self.mean, config["data_seed"]),
                                 dtype=torch.float64, device=device)

    def vg(self, z):
        return value_grad(z.to(torch.float64), self.y, self.L, self.mean)


def step_size_search(z0, momentum, vg, tol: float, max_iter: int = 100):
    """Hoffman & Gelman's Algorithm 4 a chain from ε = 1, as
    ``reference.logreg.step_size_search``, for any target's ``vg``: (ε (C,),
    ambiguous (C,))."""
    lt, g = vg(z0)
    h0 = lt - 0.5 * (momentum * momentum).sum(-1)
    half = math.log(0.5)

    def ratio(eps):
        e = eps[:, None]
        ph = momentum + 0.5 * e * g
        lt1, g1 = vg(z0 + e * ph)
        p1 = ph + 0.5 * e * g1
        r = lt1 - 0.5 * (p1 * p1).sum(-1) - h0
        return torch.where(torch.isnan(r), torch.full_like(r, -math.inf), r)

    eps = torch.ones(z0.shape[0], dtype=z0.dtype, device=z0.device)
    r = ratio(eps)
    ambiguous = (r - half).abs() < tol
    a = torch.where(r > half, 1.0, -1.0).to(eps.dtype)
    active = a * r > -a * math.log(2.0)
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        eps = torch.where(active, eps * torch.pow(2.0, a), eps)
        r = ratio(eps)
        ambiguous |= active & ((r - half).abs() < tol)
        active = active & (a * r > -a * math.log(2.0))
    return eps, ambiguous


def proposal_check(key: int, step: int, chains, prev_pos, x_prop, p_end, inv_mass,
                   prob: Problem, accept_prog, a_prog, accept_tol: float, block: int = 1024):
    """A transition judged from the program's own proposal, as
    ``reference.logreg.proposal_check`` does for the logreg, on ``prob``'s
    device: (the widest gap of min(1, e^ΔH) from ``a_prog``, the count of
    decisions ``accept_prog`` that differ from ΔH > log u outside
    ``accept_tol``)."""
    dev, vg = prob.L.device, prob.vg
    f64 = dict(dtype=torch.float64, device=dev)
    D = prev_pos.shape[-1]
    im = inv_mass.to(**f64)
    gap, wrong = 0.0, 0
    for s in range(0, chains.shape[0], block):
        ch = chains[s:s + block].to(device=dev, dtype=torch.int64)
        z = R.keyed_momenta(key, ch, torch.tensor([step], device=dev), D, dev)[0]
        p0 = z * torch.rsqrt(im)
        logu = torch.log(P.u01(P.words(key, ch, step, P.MH_SITE - P.ACCEPT, 0)[0]))
        lt0, _ = vg(prev_pos[s:s + block].to(**f64))
        lt1, _ = vg(x_prop[s:s + block].to(**f64))
        pe = p_end[s:s + block].to(**f64)
        ratio = (lt1 - 0.5 * (im * pe * pe).sum(-1)) - (lt0 - 0.5 * (im * p0 * p0).sum(-1))
        ratio = torch.where(torch.isnan(ratio), torch.full_like(ratio, -math.inf), ratio)
        a = torch.exp(torch.clamp_max(ratio, 0.0))
        gap = max(gap, float((a - a_prog[s:s + block].to(**f64)).abs().max()))
        near = (ratio - logu).abs() < accept_tol
        wrong += int((((ratio > logu) != accept_prog[s:s + block].to(dev)) & ~near).sum())
    return gap, wrong


def hmc_path(jobs, prob: Problem, accept_tol: float, leap_tol: float):
    """Replay HMC steps of the jobs' sampled chains side by side on ``prob``,
    each step under the step size, trajectory length and
    inverse mass the program ran it with, as ``reference.logreg.hmc_path``
    does for the whitened logreg (the same keys in ``jobs``; ``L`` is not
    read).  Returns (the widest trace gap, the widest gap of the acceptance
    statistic, the count of differing decisions)."""
    dev, vg = prob.L.device, prob.vg
    f64 = dict(dtype=torch.float64, device=dev)
    parts, mismatches = [], 0
    units = {job["trace_unit"] for job in jobs}
    assert len(units) == 1, units
    unit = units.pop()
    for job in jobs:
        D = job["start"].shape[-1]
        steps = torch.as_tensor(job["steps"], dtype=torch.int64)
        n, wrong_n = R.leap_counts(job["key"], steps, job["eps"], job["log_traj"],
                                   job["jitter"], job["max_nleaps"], job["nleaps"], leap_tol)
        mismatches += wrong_n
        chains = job["chains"].to(device=dev, dtype=torch.int64)
        steps = steps.to(dev)
        parts.append({
            "n": n.to(dev),
            "z": R.keyed_momenta(job["key"], chains, steps, D, dev),
            "logu": torch.log(P.u01(P.words(job["key"], chains[None, :], steps[:, None],
                                            P.MH_SITE - P.ACCEPT, 0)[0])),
            "eps": job["eps"].to(**f64)[..., None],
            "inv_mass": job["inv_mass"].to(**f64),
            "accept": job["accept"].to(device=dev, dtype=torch.bool),
            "accept_stat": job["accept_stat"].to(**f64),
            "trace": job["trace"].to(**f64),
            "start": job["start"].to(**f64),
        })
    b = R.cat_jobs(parts, R.BY_STEP)
    n_max = b["n"].max(1).values.tolist()
    pos = b["start"].clone()
    lt, grad = vg(pos)
    trace_gap = torch.zeros((), **f64)
    a_gap = torch.zeros((), **f64)
    wrong = torch.zeros((), dtype=torch.int64, device=dev)
    kept_rows = torch.isfinite(b["trace"]).all(-1).any(-1).tolist()
    for j in range(len(n_max)):
        n, eps, inv_mass = b["n"][j], b["eps"][j], b["inv_mass"][j]
        p = b["z"][j] * torch.rsqrt(inv_mass)
        h0 = lt - 0.5 * (inv_mass * p * p).sum(-1)
        q, qp, qlt, qg = pos, p, lt, grad
        for k in range(n_max[j]):
            live = (k < n)[:, None]
            ph = qp + 0.5 * eps * qg
            nq = q + eps * inv_mass * ph
            nlt, ng = vg(nq)
            np_ = ph + 0.5 * eps * ng
            q, qp = torch.where(live, nq, q), torch.where(live, np_, qp)
            qlt, qg = torch.where(live[:, 0], nlt, qlt), torch.where(live, ng, qg)
        ratio = (qlt - 0.5 * (inv_mass * qp * qp).sum(-1)) - h0
        ratio = torch.where(torch.isnan(ratio), torch.full_like(ratio, -math.inf), ratio)
        a_prog = b["accept_stat"][j]
        seen = torch.isfinite(a_prog)
        a_gap = torch.maximum(a_gap, torch.where(
            seen, (torch.exp(torch.clamp_max(ratio, 0.0)) - a_prog).abs(),
            torch.zeros_like(a_prog)).max())
        logu = b["logu"][j]
        near = (ratio - logu).abs() < accept_tol
        saved = b["accept"][j]
        wrong += (((ratio > logu) != saved) & ~near).sum()
        pos = torch.where(saved[:, None], q, pos)
        lt = torch.where(saved, qlt, lt)
        grad = torch.where(saved[:, None], qg, grad)
        if kept_rows[j]:
            t = b["trace"][j]
            if unit == "bf16":
                ref = pos.to(torch.bfloat16).to(torch.float64)
                gap = (t - ref).abs() / R.bf16_ulp(torch.clamp_min(ref.abs(), 1.0))
            else:
                gap = (t - pos).abs() / torch.clamp_min(pos.abs(), 1.0)
            gap = torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap))
            trace_gap = torch.maximum(trace_gap, gap.max())
    return float(trace_gap), float(a_gap), mismatches + int(wrong)
