"""Job kind ``gibbs_conjugate``: a whole conjugate GibbsJob on the rats model
through ``GibbsJob.run`` (captured blocks of sweeps on the card).

The job's time is the benchmark's own clock around ``GibbsJob.run``,
burnin included; ESS is the least over the monitored hyperparameters.
"""

from __future__ import annotations

import time

import torch

from portbench import counters, stats
from portbench.reference import philox
from portbench.reference import rats as ref

MONITOR = ("alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")
K2_LAUNCHES_PER_SWEEP = 7


class Job:
    def __init__(self, config, traffic, device):
        import klara_tpu_torch as kt
        from klara_tpu_torch.models.examples import rats_gibbs_model

        self.kt, self.config, self.traffic, self.device = kt, config, traffic, device
        self.model, self.v0 = rats_gibbs_model(device=device)
        self.n_rats, self.n_ages = self.v0["Y"].shape

    def _job(self, sweeps, burnin):
        return self.kt.GibbsJob(self.model, {}, self.kt.MCRange(n_steps=sweeps, burnin=burnin),
                                n_chains=self.traffic["chains"], monitor=MONITOR,
                                device=self.device)

    def warm(self, seed: int):
        """A short job at the cell's chain count: the first block of sweeps
        eager, the second captured, then the buffers freed."""
        t = self.traffic
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = self._job(t["warm_sweeps"], t["warm_burnin"]).run(gen, self.v0)
        del out

    def run(self, seed: int, sample, pick=None):
        t = self.traffic
        sweeps, burnin = t["sweeps"], t["burnin"]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        job = self._job(sweeps, burnin)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        before = counters.read()
        t0 = time.perf_counter()
        out = job.run(gen, self.v0)
        sync()
        t1 = time.perf_counter()
        launches = counters.delta(before)
        finite = all(bool(torch.isfinite(v).all()) for v in out.samples.values())
        if finite:
            min_ess = min(stats.min_ess(out.samples[k][..., None]) for k in MONITOR)
            rhat = max(stats.max_rhat(out.samples[k][..., None]) for k in MONITOR)
        else:
            min_ess, rhat = 0.0, float("inf")
        idx = sample.to(self.device)
        extract = {"seed": seed, "chains": sample.clone(), "sweeps": sweeps, "burnin": burnin,
                   "trace": {k: out.samples[k][:, idx].cpu() for k in MONITOR}}
        del out
        return {
            "wall_s": t1 - t0, "sampling_s": t1 - t0, "warmup_s": None,
            "spans": {"sampling": (t0, t1)},
            "min_ess": min_ess, "rhat": rhat, "finite": finite,
            "passed": finite and rhat <= stats.RHAT_GATE,
            "steps": sweeps, "warmup_steps": 0,
            "launches": launches,
            # one draw a block: normals (C, 30) twice and (C,) twice, gammas (C,) three times
            "work": {"chains": t["chains"], "sweeps": sweeps,
                     "k2_launches": K2_LAUNCHES_PER_SWEEP * sweeps,
                     "k2_bytes": sweeps * 4 * t["chains"] * (2 * self.n_rats + 5)},
            "extract": extract,
        }


def run_key_of(seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return philox.run_key(gen, device)


def replay_all(records, config, traffic, device, dtype=torch.float64):
    """The reference's hyperparameter traces of every record's sampled
    chains, computed in ``dtype`` (all jobs' chains side by side in one
    replay), and the flags of ambiguous gamma draws: one pair a record."""
    xc, Y = ref.data(config, "cpu")
    noises, flags = [], []
    for rec in records:
        e = rec["extract"]
        noise, amb = ref.draws(run_key_of(e["seed"], device), e["chains"], e["sweeps"],
                               Y.shape[0], Y.shape[1], device, traffic["gamma_tol"])
        noises.append({b: z.cpu() for b, z in noise.items()})
        flags.append(amb.cpu())
    joined = {b: torch.cat([n[b] for n in noises], dim=1) for b in noises[0]}
    kept = ref.replay(config["start"], joined, xc, Y, records[0]["extract"]["burnin"], dtype,
                      device)
    out, at = [], 0
    for amb in flags:
        s = amb.shape[1]
        out.append(({k: v[:, at:at + s] for k, v in kept.items()}, amb))
        at += s
    return out


def control_record(job, seed: int, sample, config, traffic, device, pick=None):
    """A job's record with the control in the program's place: the plain
    reference's sweeps of the sampled chains computed in bfloat16."""
    rec = job.run(seed, sample, pick)
    (kept, _), = replay_all([rec], config, traffic, device, dtype=torch.bfloat16)
    rec["extract"]["trace"] = {k: v.float() for k, v in kept.items()}
    return rec


def check(records, config, traffic, device):
    lim = traffic["limits"]
    gap, left_out = 0.0, 0
    for rec, (kept, amb) in zip(records, replay_all(records, config, traffic, device)):
        g, n = ref.trace_gap(rec["extract"]["trace"], kept, amb, rec["extract"]["burnin"],
                             traffic["exclude_after_ambiguous"])
        gap, left_out = max(gap, g), left_out + n
    return [("trace_sd_gap", gap, lim["trace_sd_gap"])]
