"""Job kind ``chees_precond``: a whole two-stage MCJob on a logistic-regression
posterior through ``MCJob.run_preconditioned``.

Stage 1: ChEES HMC with pooled dual averaging, ensemble diagonal mass and
trajectory adaptation on the raw target; the ensemble's covariance factor
whitens the target; stage 2: HMC with a fixed trajectory length on the
whitened target, warmup then sampling (captured CUDA graphs on the card).
The trace stays in whitened space; ESS and R̂ are scored in x space through
the factor.  The traffic file gives every sampler setting.

The job runs as ``Recording``, the program's ``MCJob`` whose warmup keeps
references to what each adaptation step read and wrote (``Log``): no copy,
no kernel and no read of the device inside the timed call.  After the call
the reference judges, in float64, the step-size search (all chains), every
dual-averaging update, every mass update, the ChEES updates at sampled
steps, and a replay of both stages' transitions for the sampled chains
from the job's start (``check``).
"""

from __future__ import annotations

import contextlib
import functools
import math
import time

import torch

from portbench import counters, stats
from portbench.reference import logreg as ref
from portbench.reference import philox

# the keyed draws of one MCJob step: momentum, accept, shared jitter
K2_LAUNCHES_PER_STEP = 3


class Log:
    """What a job's warmup adaptation read and wrote at each step, kept as
    references to the program's own tensors: a stage a call of
    ``_init_states``; per step its acceptance statistics and decisions, the
    adapted state after the step, the positions at mass updates and, at the
    ChEES steps in ``chees_steps`` of stage 1, the update's inputs."""

    def __init__(self, mass_period: int, burnin: int, chees_steps):
        self.mass_period, self.burnin = mass_period, burnin
        self.chees_steps = set(chees_steps)
        self.stages = []

    def begin(self, states):
        self.stages.append({"init": states._replace(position=None, logtarget=None,
                                                    gradlogtarget=None),
                            "steps": [], "mass": {}, "chees": {}})

    def step(self, i, prev_pos, states, infos, new, frac):
        st = self.stages[-1]
        st["steps"].append((infos.accept_stat, infos.accept, infos.extras["nleaps"], frac,
                            new._replace(position=None, logtarget=None,
                                         gradlogtarget=None)))
        if (i + 1) % self.mass_period == 0 and i < self.burnin:
            st["mass"][i] = states.position
        if len(self.stages) == 1 and i in self.chees_steps:
            st["chees"][i] = (prev_pos, infos.extras["x_prop"], infos.extras["p_end"])


def recording(mcjob):
    class Recording(mcjob):
        """The program's ``MCJob``, its warmup kept in ``Recording.log``."""

        log = None

        def _init_states(self, stream, x0, momentum=None):
            states = super()._init_states(stream, x0, momentum)
            if Recording.log is not None:
                Recording.log.begin(states)
            return states

        def adapt(self, prev_pos, states, infos, i, frac_shared=1.0):
            new = super().adapt(prev_pos, states, infos, i, frac_shared)
            if Recording.log is not None:
                Recording.log.step(i, prev_pos, states, infos, new, frac_shared)
            return new

    return Recording


def _stage(st, idx, n_steps):
    """One stage's log taken apart: the pooled values (chain 0's; the
    acceptance statistic's mean over every chain in float64), the sampled
    chains' per-step values, and the settings each of ``n_steps`` ran
    under (the last rows, past the log, are filled by the caller)."""
    steps, init = st["steps"], st["init"]
    post = [s[4] for s in steps]
    stat = torch.stack([s[0] for s in steps])
    col = lambda f: torch.stack([f(p) for p in post])  # noqa: E731
    pre = [init] + post[:-1]
    out = {
        "step0": float(init.tune.step[0]),
        "a_mean": stat.double().mean(1).cpu(),
        "step": col(lambda p: p.tune.step[0]).cpu(),
        "eps_bar": col(lambda p: p.tune.extra.eps_bar[0]).cpu(),
        "log_traj": col(lambda p: p.log_traj[0]).cpu(),
        "traj_m": col(lambda p: p.traj_m[0]).cpu(),
        "traj_v": col(lambda p: p.traj_v[0]).cpu(),
        "inv_mass": col(lambda p: p.inv_mass[0]).cpu(),
        "frac": torch.stack([torch.as_tensor(s[3], dtype=torch.float32,
                                             device=stat.device) for s in steps]).cpu(),
        "accept_stat": stat[:, idx].cpu(),
        "accept": torch.stack([s[1][idx] for s in steps]).cpu(),
        "nleaps": torch.stack([s[2][idx] for s in steps]).cpu(),
        "pre_eps": torch.stack([p.tune.step[idx] for p in pre]).cpu(),
        "pre_log_traj": torch.stack([p.log_traj[idx] for p in pre]).cpu(),
        "pre_inv_mass": torch.stack([p.inv_mass[idx] for p in pre]).cpu(),
        "mass_pos": {i: x.cpu() for i, x in st["mass"].items()},
        "mass_pos_sampled": {i: x[idx].cpu() for i, x in st["mass"].items()},
        "chees": {},
    }
    for i, (x0, xp, pe) in st["chees"].items():
        a, p = steps[i][0], post[i]
        out["chees"][i] = {"prev_pos": x0.cpu(), "x_prop": xp.cpu(), "p_end": pe.cpu(),
                           "accept_stat": a.cpu(), "accept": steps[i][1].cpu(),
                           "inv_mass": p.inv_mass.cpu(),
                           "frac": float(steps[i][3]), "eps": float(p.tune.step[0])}
    assert len(steps) <= n_steps
    return out


class Job:
    """Set-up (the target, once), a warm job, then whole jobs by seed."""

    def __init__(self, config, traffic, device):
        import klara_tpu_torch as kt
        from klara_tpu_torch.models.examples import synthetic_logistic_regression

        self.kt, self.config, self.traffic, self.device = kt, config, traffic, device
        self.target, _, _ = synthetic_logistic_regression(
            dim=config["dim"], n_data=config["n_data"], prior_var=config["prior_var"],
            seed=config["data_seed"], device=device)
        self.dim = config["dim"]
        self.mcjob = recording(kt.MCJob)

    def _job(self, chains, burnin, post):
        kt, t = self.kt, self.traffic
        s1, da = t["stage1"], t["dual_averaging"]
        sampler = kt.HMC(leapstep=s1["leapstep"], nleaps=s1["nleaps"],
                         trajectory_length=s1["trajectory_length"], jitter=s1["jitter"],
                         jitter_style="step", max_nleaps=s1["max_nleaps"])
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

    def _stage2(self):
        s2 = self.traffic["stage2"]
        sampler = self.kt.HMC(leapstep=s2["leapstep"], nleaps=s2["nleaps"],
                              trajectory_length=s2["trajectory_length"], jitter=s2["jitter"],
                              jitter_style="step", max_nleaps=s2["max_nleaps"])
        return dict(sampler=sampler, traj_adaptation=False)

    def _k2_schedule(self, chains, burnin, post):
        """The job's keyed draws: three a step of both stages (momentum,
        accept, the shared jitter of chain 0) and stage 1's step-size
        search's momentum."""
        n_steps = 2 * burnin + 1 + post
        return {"k2_launches": K2_LAUNCHES_PER_STEP * n_steps + 1,
                "k2_bytes": n_steps * 4 * (chains * self.dim + chains + 1)
                + 4 * chains * self.dim}

    def _start(self, gen, chains):
        return self.traffic["start_scale"] * torch.randn(chains, self.dim, generator=gen,
                                                         device=self.device)

    def warm(self, seed: int):
        """A short job at the cell's chain count and widths: every eager
        path once, the first block of each captured kind and its capture,
        then the buffers freed."""
        t = self.traffic
        gen = torch.Generator(device=self.device).manual_seed(seed)
        job = self._job(t["chains"], t["warm_burnin"], t["warm_post"])
        self.mcjob.log = Log(t["mass_period"], t["warm_burnin"], ())
        try:
            out = job.run_preconditioned(gen, self._start(gen, t["chains"]),
                                         stage2_replace=self._stage2(), back_transform=False)
        finally:
            self.mcjob.log = None
        del out

    def chees_steps(self, pick):
        """The stage-1 steps whose ChEES update the reference recomputes: the
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
        log = Log(t["mass_period"], burnin,
                  self.chees_steps(pick or torch.Generator().manual_seed(seed)))
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        before = counters.read()
        self.mcjob.log = log
        try:
            t0 = time.perf_counter()
            chain, timings, info = job.run_preconditioned(
                gen, x0, stage2_replace=self._stage2(), back_transform=False)
            sync()
            t1 = time.perf_counter()
        finally:
            self.mcjob.log = None
        launches = counters.delta(before)
        samp = timings["sampling_seconds"]
        values, chol = chain.value, info["chol"]
        finite = bool(torch.isfinite(values).all())
        min_ess = stats.min_ess(values, chol) if finite else 0.0
        rhat = stats.max_rhat(values, chol) if finite else float("inf")
        end, s1 = chain.final_state, info["stage1_state"]
        idx = sample.to(values.device)
        extract = {
            "seed": seed, "burnin": burnin, "chains": sample.clone(),
            "trace": values[:, idx].float().cpu(), "accept": chain["accept"][:, idx].cpu(),
            "nleaps": chain["nleaps"][:, idx].cpu(),
            "eps": end.tune.step[idx].cpu(), "inv_mass": end.inv_mass[idx].cpu(),
            "log_traj": end.log_traj[idx].cpu(),
            "position": end.position.cpu(), "logtarget": end.logtarget.cpu(),
            "grad": end.gradlogtarget.cpu(), "chol": chol.cpu(),
            "stage1_end": s1.position.cpu(), "stage1_trace_dtype": str(values.dtype),
            "stage1_final": {"eps": s1.tune.step[idx].cpu(), "log_traj": s1.log_traj[idx].cpu(),
                             "inv_mass": s1.inv_mass[idx].cpu(), "step": float(s1.tune.step[0])},
            "warmup": [_stage(st, idx, burnin) for st in log.stages],
        }
        evals = float(chain["nleaps"][:, 0].to(torch.float64).sum())
        draws = self._k2_schedule(chains, burnin, post)
        del chain, info, values, end, s1, log
        return {
            "wall_s": t1 - t0, "sampling_s": samp, "warmup_s": (t1 - t0) - samp,
            "spans": {"warmup": (t0, t1 - samp), "sampling": (t1 - samp, t1)},
            "min_ess": min_ess, "rhat": rhat, "finite": finite,
            "passed": finite and rhat <= stats.RHAT_GATE,
            "steps": post, "warmup_steps": 2 * burnin + 1,
            "launches": launches,
            "work": {"chains": chains, "dim": self.dim, "n_data": self.config["n_data"],
                     "sampling_evals": evals, **draws},
            "extract": extract,
        }


@contextlib.contextmanager
def lower_precision():
    """The program's own path one precision below f32: K1 in one TF32 pass
    (``passes=1``) and cuBLAS's f32 products in TF32."""
    from klara_tpu_torch.models import examples

    vg, tf32 = examples.logreg_value_grad, torch.backends.cuda.matmul.allow_tf32
    examples.logreg_value_grad = functools.partial(vg, passes=1)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        examples.logreg_value_grad, torch.backends.cuda.matmul.allow_tf32 = vg, tf32


def control_record(job, seed: int, sample, config, traffic, device, pick=None):
    """A job's record with the control in the program's place: the program
    on its lower-precision path, and the adaptation's arithmetic (dual
    averaging, mass, ChEES), which that path leaves in f32, as the plain
    reference computes it in bfloat16."""
    with lower_precision():
        rec = job.run(seed, sample, pick)
    e, bf16 = rec["extract"], torch.bfloat16
    x0, key1, _ = draws_of(seed, traffic["chains"], config["dim"], traffic["start_scale"],
                           device)
    X, y = (torch.as_tensor(a, dtype=bf16, device=device) for a in ref.synthetic_data(
        config["dim"], config["n_data"], config["data_seed"]))
    e["warmup"][0]["step0"] = float(torch.exp(torch.cat([
        torch.log(_search(x0[s:s + 4096], s, key1, X, y, config, traffic, bf16)[0])
        for s in range(0, x0.shape[0], 4096)]).mean()))
    s2_step0 = float(config["dim"]) ** -0.25
    for w, step0 in zip(e["warmup"], (None, s2_step0)):
        da = traffic["dual_averaging"]
        w["step"], w["eps_bar"] = (t.double() for t in ref.dual_averaging(
            w["step0"] if step0 is None else step0, w["a_mean"], traffic["target_accept"],
            da["gamma"], da["t0"], da["kappa"], dtype=bf16))
        for i, x in w["mass_pos"].items():
            w["inv_mass"][i] = ref.ensemble_inv_mass(x, bf16).double()
        for i, c in w["chees"].items():
            lt, m, v = _chees_ref(w, i, c, traffic, bf16)
            w["log_traj"][i], w["traj_m"][i], w["traj_v"][i] = lt.double(), m.double(), \
                v.double()
    return rec


def draws_of(seed: int, chains: int, dim: int, start_scale: float, device):
    """A job's start (C, D) and its two stages' run keys, as the job draws
    them from ``seed``'s generator: the start, stage 1's key, then stage 2's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x0 = start_scale * torch.randn(chains, dim, generator=gen, device=device)
    return x0, philox.run_key(gen, device), philox.run_key(gen, device)


def _chees_ref(w, i, c, traffic, dtype):
    """The reference's ChEES update at stage-1 step ``i`` from the
    program's inputs and its state before the step."""
    if i == 0:
        lt, m, v = math.log(traffic["stage1"]["trajectory_length"]), 0.0, 0.0
    else:
        lt, m, v = (float(w[k][i - 1]) for k in ("log_traj", "traj_m", "traj_v"))
    return ref.chees_step(i, c["prev_pos"], c["x_prop"], c["p_end"], c["accept_stat"],
                          c["inv_mass"], c["frac"], c["eps"], lt, m, v, traffic["traj_lr"],
                          traffic["stage1"]["max_nleaps"], traffic["stage1"]["jitter"], dtype)


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def adaptation_gaps(e, config, traffic):
    """(tune_gap, mass_gap, chees_gap) of one job: every dual-averaging
    update against the reference's recursion from the stage's first step
    size and the pooled acceptance statistics, and the step each stage
    finalised; every mass update against the reference's regularised
    variance of the program's positions, and the mass held between them;
    the ChEES updates at the checked steps against the reference's from
    their inputs, and log λ held outside the adaptation window."""
    da, burnin = traffic["dual_averaging"], e["burnin"]
    tune = mass = chees = 0.0
    s2_step0 = float(config["dim"]) ** -0.25
    finals = (e["stage1_final"]["step"], float(e["eps"][0]))
    for s, (w, final) in enumerate(zip(e["warmup"], finals)):
        step0 = w["step0"] if s == 0 else s2_step0
        steps, bars = ref.dual_averaging(step0, w["a_mean"], traffic["target_accept"],
                                         da["gamma"], da["t0"], da["kappa"])
        tune = max(tune, _rel(w["step"], steps), _rel(w["eps_bar"], bars),
                   _rel(final, bars[-1]), _rel(w["step0"], step0))
        inv = w["inv_mass"].double()
        held = torch.ones_like(inv[0])
        for i in range(burnin):
            if i in w["mass_pos"]:
                mass = max(mass, _rel(inv[i], ref.ensemble_inv_mass(w["mass_pos"][i])))
            else:
                mass = max(mass, _rel(inv[i], held))
            held = inv[i]
        if s == 0:
            lt = w["log_traj"].double()
            first = int(burnin * traffic["traj_start_frac"])
            lt0 = math.log(traffic["stage1"]["trajectory_length"])
            chees = max(chees, float((lt[:first] - lt0).abs().max()) if first else 0.0)
            for i, c in w["chees"].items():
                r_lt, r_m, r_v = _chees_ref(w, i, c, traffic, torch.float64)
                scale = float(torch.sqrt(r_v).clamp_min(1e-30))
                chees = max(chees, abs(float(w["log_traj"][i]) - float(r_lt)),
                            abs(float(w["traj_m"][i]) - float(r_m)) / scale,
                            abs(float(w["traj_v"][i]) - float(r_v)) / float(r_v.clamp_min(1e-60)))
    return tune, mass, chees


def _search(x0, first: int, key1, X, y, config, traffic, dtype):
    """The reference's step-size search of the chains ``first``, ``first`` +
    1, ... at positions ``x0``, in ``dtype``: (ε, ambiguous)."""
    dev = x0.device
    ch = torch.arange(first, first + x0.shape[0], dtype=torch.int64, device=dev)
    w = philox.words(key1, ch[:, None], 0, philox.MH_SITE - philox.INIT_MOMENTUM,
                     torch.arange(x0.shape[1], dtype=torch.int64, device=dev)[None, :])
    return ref.step_size_search(x0.to(dtype), philox.normal(w[0], w[1], dtype), X.to(dtype),
                                y.to(dtype), config["prior_var"], traffic["accept_tol"])


def search_gap(e, x0, key1, X, y, config, traffic, device):
    """How far the program's pooled first step size lies from the
    reference's search over every chain (the geometric mean), beyond what
    its ambiguous chains (a test within ``accept_tol`` of log ½; each may
    have stopped up to two doublings away) allow, in log units."""
    C = x0.shape[0]
    logs, n_amb = [], 0
    for s in range(0, C, 4096):
        eps, amb = _search(x0[s:s + 4096], s, key1, X, y, config, traffic, torch.float64)
        logs.append(torch.log(eps))
        n_amb += int(amb.sum())
    ref_log = float(torch.cat(logs).mean())
    return max(0.0, abs(math.log(e["warmup"][0]["step0"]) - ref_log) - n_amb * math.log(4.0) / C)


def _replays(jobs, e_list, config, traffic):
    """The two stages' replays, each job's sampled chains from the job's own
    start: stage 1 on the raw target over its first ``s1_replay_steps``
    steps (judged by its acceptance statistics, its decisions and its
    positions where kept; past them ChEES's trajectories grow to a hundred
    leaps and more, along which float64 and float32 paths part), stage 2 on
    the whitened target from the reference's whitening of stage 1's end
    (warmup, then sampling, judged by its trace)."""
    t = traffic
    s1, s2 = [], []
    nan = float("nan")
    T1 = t["s1_replay_steps"]
    for job, e in zip(jobs, e_list):
        w1, w2 = e["warmup"]
        S, D = e["chains"].shape[0], config["dim"]
        burnin, post = e["burnin"], e["trace"].shape[0]
        trace1 = torch.full((T1, S, D), nan, dtype=torch.float64)
        for i, x in w1["mass_pos_sampled"].items():
            if i < T1:
                trace1[i] = x.double()
        s1.append({
            "key": job["key1"], "chains": e["chains"], "steps": torch.arange(T1),
            "start": job["x0"][e["chains"].to(job["x0"].device)], "L": None,
            "jitter": t["stage1"]["jitter"], "max_nleaps": t["stage1"]["max_nleaps"],
            "eps": w1["pre_eps"][:T1], "log_traj": w1["pre_log_traj"][:T1],
            "inv_mass": w1["pre_inv_mass"][:T1], "nleaps": w1["nleaps"][:T1],
            "accept": w1["accept"][:T1], "accept_stat": w1["accept_stat"][:T1],
            "trace": trace1, "trace_unit": "relative",
        })
        # stage 2 starts where the program's did: stage 1's end as its trace
        # stored it, whitened by the reference's own factor
        x_end = e["stage1_end"][e["chains"]].to(
            getattr(torch, e["stage1_trace_dtype"].split(".")[-1])).double()
        L = job["L"].cpu()
        y0 = torch.linalg.solve_triangular(L, x_end.T, upper=False).T
        trace2 = torch.full((burnin + post, S, D), nan, dtype=torch.float64)
        trace2[burnin:] = e["trace"].double()
        trace2[burnin:burnin + t["judge_from_draw"]] = nan
        s2.append({
            "key": job["key2"], "chains": e["chains"], "steps": torch.arange(burnin + post),
            "start": y0, "L": L, "jitter": t["stage2"]["jitter"],
            "max_nleaps": t["stage2"]["max_nleaps"],
            "eps": torch.cat([w2["pre_eps"], e["eps"][None].expand(post, S)]),
            "log_traj": torch.cat([w2["pre_log_traj"], e["log_traj"][None].expand(post, S)]),
            "inv_mass": torch.cat([w2["pre_inv_mass"],
                                   e["inv_mass"][None].expand(post, S, D)]),
            "nleaps": torch.cat([w2["nleaps"].long(), e["nleaps"].long()]),
            "accept": torch.cat([w2["accept"], e["accept"]]),
            "accept_stat": torch.cat([w2["accept_stat"].double(),
                                      torch.full((post, S), nan, dtype=torch.float64)]),
            "trace": trace2, "trace_unit": "bf16",
        })
    return s1, s2


def check(records, config, traffic, device):
    """The reference's numbers over the window's jobs: [(name, value, limit)]."""
    lim, t = traffic["limits"], traffic
    X, y = ref.synthetic_data(config["dim"], config["n_data"], config["data_seed"])
    X = torch.as_tensor(X, dtype=torch.float64, device=device)
    y = torch.as_tensor(y, dtype=torch.float64, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    worst = dict.fromkeys(("chol_gap", "value_gap", "grad_gap", "search_gap", "tune_gap",
                           "mass_gap", "chees_gap", "accept_stat_gap", "s1_replay_gap",
                           "trace_bf16_ulps"), 0.0)
    worst["decision_mismatches"] = 0
    jobs, extracts = [], []
    for rec in records:
        e = rec["extract"]
        # stage 1's end as the stage-2 covariance read it: the trace's dtype
        x_end = e["stage1_end"].to(getattr(torch, e["stage1_trace_dtype"].split(".")[-1]))
        L = ref.ensemble_cholesky(x_end.to(**f64), t["ridge"])
        worst["chol_gap"] = max(worst["chol_gap"], float(
            (e["chol"].to(**f64) - L).abs().max() / L.abs().max()))
        for s in range(0, e["position"].shape[0], 4096):
            v, g = ref.value_grad(e["position"][s:s + 4096].to(**f64) @ L.T, X, y,
                                  config["prior_var"])
            g = g @ L
            gscale = float(g.abs().amax(-1).median())
            vscale = float(v.abs().median())
            worst["value_gap"] = max(worst["value_gap"], float(
                (e["logtarget"][s:s + 4096].to(**f64) - v).abs().max()) / vscale)
            worst["grad_gap"] = max(worst["grad_gap"], float(
                (e["grad"][s:s + 4096].to(**f64) - g).abs().max()) / gscale)
        x0, key1, key2 = draws_of(e["seed"], t["chains"], config["dim"], t["start_scale"],
                                  device)
        worst["search_gap"] = max(worst["search_gap"],
                                  search_gap(e, x0, key1, X, y, config, t, device))
        tune, mass, chees = adaptation_gaps(e, config, t)
        worst["tune_gap"] = max(worst["tune_gap"], tune)
        worst["mass_gap"] = max(worst["mass_gap"], mass)
        worst["chees_gap"] = max(worst["chees_gap"], chees)
        w1, T1 = e["warmup"][0], t["s1_replay_steps"]
        _, wrong = ref.leap_counts(key1, torch.arange(T1, e["burnin"]), w1["pre_eps"][T1:],
                                   w1["pre_log_traj"][T1:], t["stage1"]["jitter"],
                                   t["stage1"]["max_nleaps"], w1["nleaps"][T1:], t["leap_tol"])
        worst["decision_mismatches"] += wrong
        held = torch.ones(config["dim"])
        for i, c in sorted(w1["chees"].items()):
            im = w1["inv_mass"][i - 1] if i > 0 else held
            gap, wrong = ref.proposal_check(
                key1, i, torch.arange(t["chains"]), c["prev_pos"], c["x_prop"], c["p_end"], im,
                X, y, config["prior_var"], c["accept"], c["accept_stat"], t["accept_tol"])
            worst["accept_stat_gap"] = max(worst["accept_stat_gap"], gap)
            worst["decision_mismatches"] += wrong
        jobs.append({"x0": x0.double(), "key1": key1, "key2": key2, "L": L})
        extracts.append(e)
        del x0
    s1, s2 = _replays(jobs, extracts, config, t)
    end_gap, a1, wrong1 = ref.hmc_path(s1, X, y, config["prior_var"], t["accept_tol"],
                                       t["leap_tol"])
    ulps, a2, wrong2 = ref.hmc_path(s2, X, y, config["prior_var"], t["accept_tol"],
                                    t["leap_tol"])
    worst.update(s1_replay_gap=end_gap, trace_bf16_ulps=ulps,
                 accept_stat_gap=max(worst["accept_stat_gap"], a1, a2),
                 decision_mismatches=worst["decision_mismatches"] + wrong1 + wrong2)
    return [(k, v, lim[k]) for k, v in worst.items()]
