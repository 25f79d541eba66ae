"""Plain reference of the logistic-regression posterior and its whitened
HMC transition, in float64 torch.  Imports nothing of the program.

Posterior: loglik(p) = (Xp)ᵀy − Σ softplus(Xp), logprior(p) = −½(pᵀp/λ +
D·log 2πλ), λ the prior variance.  Whitened by x = L y, the log-density of y
is that of x (no Jacobian: L is a constant) and grad_y = grad_x L.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import philox as P


def synthetic_data(dim: int, n_data: int, seed: int):
    """Covariates ~ N(0, I), true weights ~ N(0, 1), labels Bernoulli(σ(Xw)),
    drawn in f32 from NumPy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_data, dim)).astype(np.float32)
    w = rng.standard_normal(dim).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-X @ w))
    y = (rng.random(n_data) < probs).astype(np.float32)
    return X, y


def value_grad(x, X, y, prior_var: float):
    """(log-density (C,), gradient (C, D)) at the (C, D) positions ``x``, in
    the dtype of the inputs."""
    logits = x @ X.T
    d = x.shape[-1]
    value = logits @ y - torch.nn.functional.softplus(logits).sum(-1) \
        - 0.5 * ((x * x).sum(-1) / prior_var + d * math.log(2.0 * math.pi * prior_var))
    grad = (y - torch.sigmoid(logits)) @ X - x / prior_var
    return value, grad


def ensemble_cholesky(x_end, ridge: float):
    """The factor of the ensemble covariance of the (C, D) positions, shrunk
    toward its diagonal with weight n/(n + D) and ridged by ``ridge`` times
    its mean diagonal (+1e-12), in the dtype of ``x_end``."""
    n, d = x_end.shape
    xc = x_end - x_end.mean(0, keepdim=True)
    cov = xc.T @ xc / (n - 1)
    w = n / (n + d)
    cov = w * cov + (1.0 - w) * torch.diag(torch.diagonal(cov))
    lam = ridge * torch.diagonal(cov).mean() + 1e-12
    return torch.linalg.cholesky(cov + lam * torch.eye(d, dtype=cov.dtype, device=cov.device))


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (at least the smallest normal's)."""
    e = torch.floor(torch.log2(torch.clamp_min(x.abs(), 2.0**-126)))
    return torch.exp2(e - 7)


def batched_value_grad(X, y, prior_var: float, L):
    """The whitened target's (value, gradient) at (S, D) positions y, chain s
    under its own factor L[s] (S, D, D): x = L y, grad_y = Lᵀ grad_x."""

    def vg(yy):
        v, g = value_grad(torch.einsum("sij,sj->si", L, yy), X, y, prior_var)
        return v, torch.einsum("si,sij->sj", g, L)

    return vg


def keyed_momenta(key, chains, steps, D, dev):
    """The momentum normals (steps, S, D) the chains drew at ``steps``."""
    w = P.words(key, chains[None, :, None], steps[:, None, None], P.MH_SITE - P.MOMENTUM,
                torch.arange(D, dtype=torch.int64, device=dev)[None, None, :])
    return P.normal(w[0], w[1])


def step_size_search(x0, momentum, X, y, prior_var: float, tol: float, max_iter: int = 100):
    """Hoffman & Gelman's Algorithm 4 a chain, from ε = 1: one leapfrog step
    of unit mass from ``x0`` with ``momentum``, ε doubled while the
    acceptance probability stays above ½ (halved while it stays below).
    Returns (ε (C,), ambiguous (C,)): a chain is ambiguous where a log ratio
    it tested came within ``tol`` of log ½, so that another precision may
    have stopped it a doubling or two away."""
    lt, g = value_grad(x0, X, y, prior_var)
    h0 = lt - 0.5 * (momentum * momentum).sum(-1)
    half = math.log(0.5)

    def ratio(eps):
        e = eps[:, None]
        ph = momentum + 0.5 * e * g
        x = x0 + e * ph
        lt1, g1 = value_grad(x, X, y, prior_var)
        p1 = ph + 0.5 * e * g1
        r = lt1 - 0.5 * (p1 * p1).sum(-1) - h0
        return torch.where(torch.isnan(r), torch.full_like(r, -math.inf), r)

    eps = torch.ones(x0.shape[0], dtype=x0.dtype, device=x0.device)
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


def dual_averaging(step0: float, a_mean, target: float, gamma: float, t0: float,
                   kappa: float, dtype=torch.float64):
    """Hoffman & Gelman's dual averaging (Algorithm 6) of one pooled step size
    from ``step0`` (μ = log 10·step0), fed the pooled acceptance statistic
    of each warmup step ``a_mean`` (T,): (the step size after each update,
    the averaged step after each update), (T,) each, in ``dtype``."""
    a_mean = a_mean.to(dtype)
    mu = torch.log(torch.tensor(10.0 * step0, dtype=dtype))
    eps_bar = torch.ones((), dtype=dtype)
    h_bar = torch.zeros((), dtype=dtype)
    steps, bars = [], []
    for t in range(1, a_mean.shape[0] + 1):
        tt = torch.tensor(float(t), dtype=dtype)
        hw = 1.0 / (tt + t0)
        h_bar = (1.0 - hw) * h_bar + hw * (target - a_mean[t - 1])
        step = torch.exp(mu - torch.sqrt(tt) * h_bar / gamma)
        ew = tt ** (-kappa)
        eps_bar = torch.exp((1.0 - ew) * torch.log(eps_bar) + ew * torch.log(step))
        steps.append(step)
        bars.append(eps_bar)
    return torch.stack(steps), torch.stack(bars)


def ensemble_inv_mass(positions, dtype=torch.float64):
    """The diagonal inverse mass from the ensemble's (C, D) positions: Stan's
    regularised variance n/(n+5)·var + 5/(n+5)·1e-3 (population variance
    over the n chains), plus 1e-7."""
    x = positions.to(dtype)
    n = x.shape[0]
    var = ((x - x.mean(0)) ** 2).mean(0)
    w = n / (n + 5.0)
    return w * var + (1.0 - w) * 1e-3 + 1e-7


def chees_step(i: int, prev_pos, x_prop, p_end, accept_stat, inv_mass, frac: float,
               eps: float, lt: float, m: float, v: float, lr: float, max_nleaps: int,
               jitter: float, dtype=torch.float64):
    """One ChEES update of log λ (Hoffman, Radul & Sountsov 2021) at warmup
    step ``i``: the ensemble's gradient of the expected squared jump
    distance change, whitened by the inverse mass, each chain weighted by
    its acceptance statistic over the mean and scaled by the jitter
    fraction, then one Adam step (β 0.9, 0.999) on log λ, clamped to
    [log 1e-2, log 1e3] and capped at what ``max_nleaps`` leaps of the step
    size ``eps`` reach under the jitter's widest fraction.  Returns (log λ,
    m, v) in ``dtype``."""
    c = lambda t: t.to(dtype)  # noqa: E731
    x0, xp, pe, a, iw = c(prev_pos), c(x_prop), c(p_end), c(accept_stat), 1.0 / c(inv_mass)
    dold = (iw * (x0 - x0.mean(0)) ** 2).sum(-1)
    dnew = (iw * (xp - xp.mean(0)) ** 2).sum(-1)
    proj = ((xp - xp.mean(0)) * pe).sum(-1)
    w = a / torch.clamp_min(a.mean(), 1e-3)
    g = (w * (dnew - dold) * proj * frac).mean()
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat = m / (1.0 - 0.9 ** (i + 1))
    vhat = v / (1.0 - 0.999 ** (i + 1))
    lt_new = lt + lr * mhat / (torch.sqrt(vhat) + 1e-8)
    lt_new = torch.clamp(lt_new, math.log(1e-2), math.log(1e3))
    cap = torch.log(torch.tensor(eps * max_nleaps / (1.0 + jitter), dtype=dtype))
    return torch.minimum(lt_new, cap), m, v


def shared_fractions(key: int, steps, jitter: float):
    """The shared jitter fraction of each of ``steps``: global chain 0's
    uniform at the step's ``SHARED_JITTER`` site mapped to U(1 − j, 1 + j)."""
    u = P.u01(P.words(key, 0, steps, P.MH_SITE - P.SHARED_JITTER, 0)[0])
    return torch.clamp_min(u * (2.0 * jitter) + (1.0 - jitter), 1.0 - jitter)


def cat_jobs(parts, by_step):
    """The jobs' per-chain tensors side by side: axis 1 of a (steps, S, ...)
    tensor (the names in ``by_step``), axis 0 of an (S, ...) one."""
    return {k: torch.cat([p[k] for p in parts], dim=1 if k in by_step else 0)
            for k in parts[0]}


BY_STEP = ("n", "z", "logu", "eps", "inv_mass", "accept", "accept_stat", "trace")


def leap_counts(key: int, steps, eps, log_traj, jitter: float, max_nleaps: int, saved,
                leap_tol: float):
    """The leap counts (T, S) of ``steps`` under the step sizes ``eps`` and
    log trajectory lengths ``log_traj`` (T, S) the program ran, λ scaled by
    the step's shared jitter fraction: round(λ·frac/ε) clamped to [1,
    ``max_nleaps``].  Returns (the counts, taking the program's ``saved``
    count where the quotient lies within ``leap_tol`` of a rounding tie,
    and the count of ``saved`` counts that differ elsewhere; a saved count
    below 0 is not recorded and is not judged)."""
    frac = shared_fractions(key, torch.as_tensor(steps, dtype=torch.int64), jitter)
    x = torch.exp(log_traj.double() + torch.log(frac)[:, None]) / eps.double()
    n_ref = torch.clamp(torch.round(x), 1, max_nleaps).to(torch.int64)
    tie = (x - torch.floor(x) - 0.5).abs() < leap_tol * x
    saved = saved.to(torch.int64)
    recorded = saved >= 0
    differ = (n_ref != saved) & ~tie & recorded
    return torch.where((tie | differ) & recorded, saved, n_ref), int(differ.sum())


def proposal_check(key: int, step: int, chains, prev_pos, x_prop, p_end, inv_mass, X, y,
                   prior_var: float, accept_prog, a_prog, accept_tol: float, block=4096):
    """A transition judged from the program's own proposal, for ``chains``:
    H at the start (``prev_pos``, the momentum redrawn from ``key`` at
    ``step``, unit-free z over √``inv_mass``) and at the proposal's end
    (``x_prop``, ``p_end``), in float64.  Returns (the widest gap between
    the acceptance statistic min(1, e^ΔH) and the program's ``a_prog``, the
    count of the program's decisions ``accept_prog`` that differ from ΔH >
    log u outside ``accept_tol``)."""
    dev = X.device
    f64 = dict(dtype=torch.float64, device=dev)
    D = prev_pos.shape[-1]
    im = inv_mass.to(**f64)
    gap, wrong = 0.0, 0
    for s in range(0, chains.shape[0], block):
        ch = chains[s:s + block].to(device=dev, dtype=torch.int64)
        z = keyed_momenta(key, ch, torch.tensor([step], device=dev), D, dev)[0]
        p0 = z * torch.rsqrt(im)
        logu = torch.log(P.u01(P.words(key, ch, step, P.MH_SITE - P.ACCEPT, 0)[0]))
        lt0, _ = value_grad(prev_pos[s:s + block].to(**f64), X, y, prior_var)
        lt1, _ = value_grad(x_prop[s:s + block].to(**f64), X, y, prior_var)
        pe = p_end[s:s + block].to(**f64)
        ratio = (lt1 - 0.5 * (im * pe * pe).sum(-1)) - (lt0 - 0.5 * (im * p0 * p0).sum(-1))
        ratio = torch.where(torch.isnan(ratio), torch.full_like(ratio, -math.inf), ratio)
        a = torch.exp(torch.clamp_max(ratio, 0.0))
        gap = max(gap, float((a - a_prog[s:s + block].to(**f64)).abs().max()))
        near = (ratio - logu).abs() < accept_tol
        wrong += int((((ratio > logu) != accept_prog[s:s + block].to(dev)) & ~near).sum())
    return gap, wrong


def hmc_path(jobs, X, y, prior_var: float, accept_tol: float, leap_tol: float):
    """Replay HMC steps for the jobs' sampled chains, all jobs' chains side by
    side, each step under the step size, trajectory length and inverse mass
    the program ran it with (each checked on its own against the
    reference's adaptation).

    Each of ``jobs`` holds: ``key`` (the stage's run key), ``chains`` (S,)
    global indices, ``steps`` (T,) the stream's steps, ``start`` (S, D),
    ``L`` (D, D) for the whitened target or None for the raw one,
    ``jitter``, ``max_nleaps``; the settings each step ran under, ``eps``
    and ``log_traj`` (T, S) and ``inv_mass`` (T, S, D); the program's
    ``nleaps`` (T, S, −1 where not kept) and ``accept`` (T, S),
    ``accept_stat`` (T, S, NaN where not kept) and ``trace`` (T, S, D): its positions after the step, NaN where
    not kept, in ``trace_unit`` "bf16" (judged in bfloat16 spacings at
    max(|x|, 1) of the reference rounded to bfloat16) or "relative" (|Δ| /
    max(|x|, 1)).  Draws come from the key.  A decision within
    ``accept_tol`` of its accept boundary, or a leap count within
    ``leap_tol`` of a rounding tie, is taken as the program took it;
    elsewhere a decision that differs is counted, and the replay goes on
    with the program's.  Returns (the widest trace gap, the widest gap of
    the acceptance statistic, the count of differing decisions)."""
    dev = X.device
    f64 = dict(dtype=torch.float64, device=dev)
    parts, mismatches = [], 0
    units = {job["trace_unit"] for job in jobs}
    assert len(units) == 1, units
    unit = units.pop()
    for job in jobs:
        T, S = job["nleaps"].shape
        D = job["start"].shape[-1]
        steps = torch.as_tensor(job["steps"], dtype=torch.int64)
        n, wrong_n = leap_counts(job["key"], steps, job["eps"], job["log_traj"], job["jitter"],
                                 job["max_nleaps"], job["nleaps"], leap_tol)
        mismatches += wrong_n
        chains = job["chains"].to(device=dev, dtype=torch.int64)
        steps = steps.to(dev)
        L = torch.eye(D, **f64) if job["L"] is None else job["L"].to(**f64)
        parts.append({
            "n": n.to(dev),
            "z": keyed_momenta(job["key"], chains, steps, D, dev),
            "logu": torch.log(P.u01(P.words(job["key"], chains[None, :], steps[:, None],
                                            P.MH_SITE - P.ACCEPT, 0)[0])),
            "eps": job["eps"].to(**f64)[..., None],
            "inv_mass": job["inv_mass"].to(**f64),
            "accept": job["accept"].to(device=dev, dtype=torch.bool),
            "accept_stat": job["accept_stat"].to(**f64),
            "trace": job["trace"].to(**f64),
            "start": job["start"].to(**f64),
            "L": L.expand(S, D, D),
        })
    b = cat_jobs(parts, BY_STEP)
    n_max = b["n"].max(1).values.tolist()
    vg = batched_value_grad(X.to(**f64), y.to(**f64), prior_var, b["L"])
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
                gap = (t - ref).abs() / bf16_ulp(torch.clamp_min(ref.abs(), 1.0))
            else:
                gap = (t - pos).abs() / torch.clamp_min(pos.abs(), 1.0)
            gap = torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap))
            trace_gap = torch.maximum(trace_gap, gap.max())
    return float(trace_gap), float(a_gap), mismatches + int(wrong)
