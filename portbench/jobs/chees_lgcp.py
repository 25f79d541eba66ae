"""Job kind ``chees_lgcp``: a whole MCJob on the log-Gaussian Cox process's
non-centred posterior through ``MCJob.run_phased``.

ChEES HMC with pooled dual averaging, ensemble diagonal mass and trajectory
adaptation in warmup (its transitions replayed as graph units, the hooks
eager), then sampling with the adapted settings in captured per-leap units:
stage 1 of ``chees_precond`` on a target whose every evaluation is two
(C, D)×(D, D) products around an exp.  The trace holds z; ESS and R̂ are
scored on the field x = μ + z Lᵀ through the factor (μ moves neither).  The
traffic file gives every sampler setting.

The job runs as ``Recording`` (``chees_precond``'s), which keeps references
to what each adaptation step read and wrote, and the end of warmup's
positions: no copy, kernel or device read inside the timed call.  After the
call the reference judges, in float64 (``reference.lgcp``), the final
state's value and gradient at every chain, the step-size search (every
chain), every dual-averaging and mass update, ChEES at sampled steps (every
chain's proposal there judged by ΔH), and a replay of the sampled chains
over the warmup's first steps from the job's start and over the whole
sampling phase from the recorded end of warmup, with the acceptance
statistics, accept decisions and leap counts (``check``).
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench import counters, stats
from portbench.jobs.chees_precond import (
    K2_LAUNCHES_PER_STEP,
    Log,
    _stage,
    adaptation_gaps,
    draws_of,
    recording,
)
from portbench.reference import lgcp as ref
from portbench.reference import logreg as R
from portbench.reference import philox


class EndLog(Log):
    """``Log`` that also keeps the positions after the last warmup step."""

    def step(self, i, prev_pos, states, infos, new, frac):
        super().step(i, prev_pos, states, infos, new, frac)
        if i == self.burnin - 1:
            self.end = states.position


class Job:
    """Set-up (the target and its factor, once), a warm job, then whole
    jobs by seed."""

    def __init__(self, config, traffic, device):
        import klara_tpu_torch as kt
        from klara_tpu_torch.models.lgcp import lgcp_grid

        self.kt, self.config, self.traffic, self.device = kt, config, traffic, device
        self.target, _, self.chol = lgcp_grid(
            n=config["grid"], sigma2=config["sigma2"], beta=config["beta"],
            mean=ref.mean_of(config), seed=config["data_seed"], device=device)
        self.dim = config["dim"]
        self.mcjob = recording(kt.MCJob)

    def _job(self, chains, burnin, post):
        kt, t = self.kt, self.traffic
        h, da = t["hmc"], t["dual_averaging"]
        sampler = kt.HMC(leapstep=h["leapstep"], nleaps=h["nleaps"],
                         trajectory_length=h["trajectory_length"], jitter=h["jitter"],
                         jitter_style="step", max_nleaps=h["max_nleaps"])
        trace_dtype = "bfloat16" if post * chains * self.dim * 4 > t["bf16_trace_past_bytes"] \
            else None
        return self.mcjob(
            self.target, sampler, kt.MCRange(n_steps=burnin + post, burnin=burnin),
            tuner=kt.DualAveragingTuner(t["target_accept"], burnin, gamma=da["gamma"],
                                        t0=da["t0"], kappa=da["kappa"]),
            n_chains=chains, monitor=("value",), diagnostics=("accept", "nleaps"),
            pooled_tuning=True, mass_adaptation=True, mass_period=t["mass_period"],
            trace_dtype=trace_dtype, traj_adaptation=True, traj_lr=t["traj_lr"],
            traj_start_frac=t["traj_start_frac"], device=self.device)

    def _k2_schedule(self, chains, burnin, post):
        """The job's keyed draws: three a step (momentum, accept, the shared
        jitter of chain 0) and the step-size search's momentum; the start
        is the job's generator's."""
        n_steps = burnin + post
        return {"k2_launches": K2_LAUNCHES_PER_STEP * n_steps + 1,
                "k2_bytes": n_steps * 4 * (chains * self.dim + chains + 1)
                + 4 * chains * self.dim}

    def _start(self, gen, chains):
        """Prior draws z ~ N(0, I) from the job's generator."""
        return torch.randn(chains, self.dim, generator=gen, device=self.device)

    def warm(self, seed: int):
        """A short job at the cell's chain count and widths: every eager
        path once, the first unit of each captured kind and its capture,
        then the buffers freed."""
        t = self.traffic
        gen = torch.Generator(device=self.device).manual_seed(seed)
        job = self._job(t["chains"], t["warm_burnin"], t["warm_post"])
        self.mcjob.log = EndLog(t["mass_period"], t["warm_burnin"], ())
        try:
            out = job.run_phased(gen, self._start(gen, t["chains"]))
        finally:
            self.mcjob.log = None
        del out

    def chees_steps(self, pick):
        """The warmup steps whose ChEES update the reference recomputes: the
        first and the last of the adaptation window and others drawn by
        ``pick`` (a ``torch.Generator``)."""
        t = self.traffic
        first, last = int(t["burnin"] * t["traj_start_frac"]), t["burnin"] - 1
        k = max(0, t["chees_check_steps"] - 2)
        inner = torch.randperm(last - first - 1, generator=pick)[:k] + first + 1
        return sorted({first, last, *inner.tolist()})

    def run(self, seed: int, sample, pick=None):
        """One whole job from ``seed``: timings, its score, the work it did
        and what the reference needs of it (for the chains ``sample``, and
        the ChEES steps ``pick`` draws)."""
        t = self.traffic
        chains, burnin, post = t["chains"], t["burnin"], t["post"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        x0 = self._start(gen, chains)
        job = self._job(chains, burnin, post)
        log = EndLog(t["mass_period"], burnin,
                     self.chees_steps(pick or torch.Generator().manual_seed(seed)))
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        before = counters.read()
        self.mcjob.log = log
        try:
            t0 = time.perf_counter()
            chain, timings = job.run_phased(gen, x0)
            sync()
            t1 = time.perf_counter()
        finally:
            self.mcjob.log = None
        launches = counters.delta(before)
        samp = timings["sampling_seconds"]
        values = chain.value
        finite = bool(torch.isfinite(values).all())
        min_ess = stats.min_ess(values, self.chol) if finite else 0.0
        rhat = stats.max_rhat(values, self.chol) if finite else float("inf")
        end = chain.final_state
        idx = sample.to(values.device)
        extract = {
            "seed": seed, "burnin": burnin, "chains": sample.clone(),
            "trace": values[:, idx].float().cpu(),
            "accept": chain["accept"][:, idx].cpu(), "nleaps": chain["nleaps"][:, idx].cpu(),
            "eps": end.tune.step[idx].cpu(), "inv_mass": end.inv_mass[idx].cpu(),
            "log_traj": end.log_traj[idx].cpu(), "warmup_end": log.end[idx].cpu(),
            "position": end.position.cpu(), "logtarget": end.logtarget.cpu(),
            "grad": end.gradlogtarget.cpu(),
            # the finalised pooled step, where ``adaptation_gaps`` reads it
            "stage1_final": {"step": float(end.tune.step[0])},
            "warmup": [_stage(st, idx, burnin) for st in log.stages],
        }
        del chain, values, end, log
        return {
            "wall_s": t1 - t0, "sampling_s": samp, "warmup_s": (t1 - t0) - samp,
            "spans": {"warmup": (t0, t1 - samp), "sampling": (t1 - samp, t1)},
            "min_ess": min_ess, "rhat": rhat, "finite": finite,
            "passed": finite and rhat <= stats.RHAT_GATE,
            "steps": post, "warmup_steps": burnin,
            "launches": launches,
            "work": {"chains": chains, "dim": self.dim,
                     **self._k2_schedule(chains, burnin, post)},
            "extract": extract,
        }


@contextlib.contextmanager
def lower_precision():
    """The program's products one precision below f32: cuBLAS in TF32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def control_record(job, seed: int, sample, config, traffic, device, pick=None):
    """A job's record with the control in the program's place: its
    products in TF32."""
    with lower_precision():
        return job.run(seed, sample, pick)


def _shim(traffic):
    """The traffic as ``chees_precond.adaptation_gaps`` reads a stage-1
    sampler's settings."""
    return {**traffic, "stage1": traffic["hmc"]}


def check(records, config, traffic, device):
    """The reference's numbers over the window's jobs: [(name, value, limit)]."""
    lim, t, h = traffic["limits"], traffic, traffic["hmc"]
    prob = ref.Problem(config, device)
    f64 = dict(dtype=torch.float64, device=device)
    worst = dict.fromkeys(("value_gap", "grad_gap", "search_gap", "tune_gap", "mass_gap",
                           "chees_gap", "accept_stat_gap", "warmup_replay_gap",
                           "trace_bf16_ulps"), 0.0)
    worst["decision_mismatches"] = 0
    T1 = t["warmup_replay_steps"]
    warm_jobs, samp_jobs = [], []
    for rec in records:
        e = rec["extract"]
        C = e["position"].shape[0]
        for s in range(0, C, 1024):
            v, g = prob.vg(e["position"][s:s + 1024].to(**f64))
            worst["value_gap"] = max(worst["value_gap"], float(
                (e["logtarget"][s:s + 1024].to(**f64) - v).abs().max()) / float(v.abs().median()))
            worst["grad_gap"] = max(worst["grad_gap"], float(
                (e["grad"][s:s + 1024].to(**f64) - g).abs().max())
                / float(g.abs().amax(-1).median()))
        x0, key, _ = draws_of(e["seed"], C, config["dim"], 1.0, device)
        worst["search_gap"] = max(worst["search_gap"], search_gap(e, x0, key, prob, t))
        tune, mass, chees = adaptation_gaps(e, config, _shim(t))
        worst["tune_gap"] = max(worst["tune_gap"], tune)
        worst["mass_gap"] = max(worst["mass_gap"], mass)
        worst["chees_gap"] = max(worst["chees_gap"], chees)
        w = e["warmup"][0]
        _, wrong = R.leap_counts(key, torch.arange(T1, e["burnin"]), w["pre_eps"][T1:],
                                 w["pre_log_traj"][T1:], h["jitter"], h["max_nleaps"],
                                 w["nleaps"][T1:], t["leap_tol"])
        worst["decision_mismatches"] += wrong
        held = torch.ones(config["dim"])
        for i, c in sorted(w["chees"].items()):
            im = w["inv_mass"][i - 1] if i > 0 else held
            gap, wrong = ref.proposal_check(
                key, i, torch.arange(C), c["prev_pos"], c["x_prop"], c["p_end"], im, prob,
                c["accept"], c["accept_stat"], t["accept_tol"])
            worst["accept_stat_gap"] = max(worst["accept_stat_gap"], gap)
            worst["decision_mismatches"] += wrong
        warm, samp = _replays(e, x0, key, config, t)
        warm_jobs.append(warm)
        samp_jobs.append(samp)
        del x0
    gap, a1, wrong1 = ref.hmc_path(warm_jobs, prob, t["accept_tol"], t["leap_tol"])
    ulps, a2, wrong2 = ref.hmc_path(samp_jobs, prob, t["accept_tol"], t["leap_tol"])
    worst.update(warmup_replay_gap=gap, trace_bf16_ulps=ulps,
                 accept_stat_gap=max(worst["accept_stat_gap"], a1, a2),
                 decision_mismatches=worst["decision_mismatches"] + wrong1 + wrong2)
    return [(k, v, lim[k]) for k, v in worst.items()]


def search_gap(e, x0, key, prob, traffic):
    """How far the program's pooled first step size lies from the
    reference's search over every chain (the geometric mean), beyond what
    its ambiguous chains allow, in log units (``chees_precond.search_gap``'s
    measure)."""
    C, D = x0.shape
    logs, n_amb = [], 0
    for s in range(0, C, 1024):
        ch = torch.arange(s, min(C, s + 1024), dtype=torch.int64, device=x0.device)
        wds = philox.words(key, ch[:, None], 0, philox.MH_SITE - philox.INIT_MOMENTUM,
                           torch.arange(D, dtype=torch.int64, device=x0.device)[None, :])
        eps, amb = ref.step_size_search(x0[s:s + 1024].double(), philox.normal(wds[0], wds[1]),
                                        prob.vg, traffic["accept_tol"])
        logs.append(torch.log(eps))
        n_amb += int(amb.sum())
    ref_log = float(torch.cat(logs).mean())
    return max(0.0, abs(math.log(e["warmup"][0]["step0"]) - ref_log) - n_amb * math.log(4.0) / C)


def _replays(e, x0, key, config, traffic):
    """The sampled chains' two replays of one job: the warmup's first
    ``warmup_replay_steps`` steps from the job's start (judged by acceptance
    statistics, decisions and the positions kept at mass updates), and the
    whole sampling phase from the recorded end of warmup under the final
    settings (judged by its trace in bfloat16 spacings of the reference
    rounded to bfloat16, whether the trace is bfloat16 or float32)."""
    t, h = traffic, traffic["hmc"]
    nan = float("nan")
    w, T1 = e["warmup"][0], t["warmup_replay_steps"]
    S, D = e["chains"].shape[0], config["dim"]
    burnin, post = e["burnin"], e["trace"].shape[0]
    trace1 = torch.full((T1, S, D), nan, dtype=torch.float64)
    for i, x in w["mass_pos_sampled"].items():
        if i < T1:
            trace1[i] = x.double()
    warm = {
        "key": key, "chains": e["chains"], "steps": torch.arange(T1),
        "start": x0[e["chains"].to(x0.device)], "jitter": h["jitter"],
        "max_nleaps": h["max_nleaps"],
        "eps": w["pre_eps"][:T1], "log_traj": w["pre_log_traj"][:T1],
        "inv_mass": w["pre_inv_mass"][:T1], "nleaps": w["nleaps"][:T1],
        "accept": w["accept"][:T1], "accept_stat": w["accept_stat"][:T1],
        "trace": trace1, "trace_unit": "relative",
    }
    samp = {
        "key": key, "chains": e["chains"], "steps": torch.arange(burnin, burnin + post),
        "start": e["warmup_end"], "jitter": h["jitter"], "max_nleaps": h["max_nleaps"],
        "eps": e["eps"][None].expand(post, S), "log_traj": e["log_traj"][None].expand(post, S),
        "inv_mass": e["inv_mass"][None].expand(post, S, D),
        "nleaps": e["nleaps"].long(), "accept": e["accept"],
        "accept_stat": torch.full((post, S), nan, dtype=torch.float64),
        "trace": e["trace"].double(), "trace_unit": "bf16",
    }
    return warm, samp
