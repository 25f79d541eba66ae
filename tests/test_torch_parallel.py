"""The port's multi-device layer (klara_tpu_torch.parallel, ``mesh=`` on
MCJob and GibbsJob) on CPU ranks joined by gloo, against one process and
against klara_tpu.

Counterparts of tests/test_parallel.py (the graft dry run is not ported)
and of tests/test_hardening.py::test_resume_under_mesh, plus the port's own
rules:

* the keyed streams (every draw of ``MCJob`` and ``GibbsJob``): two ranks
  against one process, bit for bit, for every sampler (HMC with the shared
  and the per-chain jitter, NUTS's two tree forms, MALA, SMMALA, MH with a
  random walk and with a proposal distribution, RAM, AM, AMWG, the slice
  sampler's in-loop draws, ARS, the prior-drawn x0) and the rats Gibbs
  conditionals with their gamma draws; each rank draws exactly its own
  chains' elements and issues no collective but the run's generator check,
  and generators seeded differently raise;
* csv output on two ranks: ``MCJob``'s stream (across a ``resume``) and
  its ``'post'`` mode, and a Gibbs job's csv variables (across a
  ``resume``) write the one process's files byte for byte;
* the statistics of a meshed chain: global on every rank, with the
  elements each one all-gathers counted (per-chain results, not draws,
  except the rank-normalised ones);
* the reductions (pooled tuning, ensemble mass, ChEES, the ensemble
  Cholesky) on two ranks against one process within 1e-6 relative (the
  sum order differs), and a one-rank mesh against no mesh bit for bit;
* ``run_preconditioned`` on two ranks: stage 1 and, from the same factor,
  stage 2 bit for bit against one process, the factor within 1e-6;
* the param-sharded logreg target on a 2 x 2 mesh against the plain
  value+grad and against JAX's ``param_sharded_logreg_target`` on
  ``mesh2d(4, 2)`` at the JAX test's tolerance, rtol 2e-5 / atol 1e-5.

Each group of ranks is spawned once per module (``sys.executable`` on this
file, its ``__main__`` branch the worker, gloo through a ``file://`` init so
that parallel test workers never race for a port).  A worker runs every
scenario of its group, compares its one-process reference in the same
process (the same thread count) and saves what each rank saw; each test
asserts its own scenario.
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import klara_tpu_torch as kt  # noqa: E402

WORKER_TIMEOUT = 240
RED_RTOL, RED_ATOL = 1e-6, 1e-7
PARITY_RTOL, PARITY_ATOL = 2e-5, 1e-5


# ------------------------------------------------------------ the scenarios
def _std_target():
    return kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _logreg_problem(D=16, N=64, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (rng.random(N) < 0.5).astype(np.float32)
    return X, y


def _meshed_and_single(rank, mesh, run):
    """``run(mesh)`` on the mesh, and on rank 0 also without one."""
    out = {"meshed": run(mesh)}
    if rank == 0:
        out["single"] = run(None)
    return out


STATS = {
    "mean": lambda c: kt.stats.mean(c), "rate": lambda c: kt.stats.acceptance(c),
    "ess": lambda c: kt.stats.ess(c), "rhat": lambda c: kt.stats.rhat(c),
    "mean_pc": lambda c: kt.stats.mean(c, per_chain=True), "mcse": lambda c: kt.stats.mcse(c),
    "iact": lambda c: kt.stats.iact(c), "ess_pc": lambda c: kt.stats.ess(c, combine_chains=False),
    "rhat_rank": lambda c: kt.stats.rhat_rank(c),
}


def _collectives():
    """The tracer's counts of the mesh's collectives, by kind."""
    from klara_tpu_torch.utils import tracing

    c = tracing.counters()
    return {k: c.get("parallel.mesh.COLLECTIVES." + k, (0, 0))[0]
            for k in ("all_reduce", "all_gather", "gathered_elements")}


def _collectives_of(fn):
    """``fn()`` and the collectives it issued, by kind."""
    before = _collectives()
    out = fn()
    return out, {k: n - before[k] for k, n in _collectives().items()}


def s_mala(rank, meshes):
    def run(mesh):
        job = kt.MCJob(_std_target(), kt.MALA(driftstep=0.8), kt.MCRange(n_steps=200, burnin=50),
                       n_chains=16, mesh=mesh)
        chain = job.run(_gen(5), torch.zeros(2))
        out, gathered = {"value": chain.value}, {}
        for name, stat in STATS.items():
            out[name], counts = _collectives_of(lambda: stat(chain))
            gathered[name] = counts["gathered_elements"]
        out["gathered"] = gathered
        return out

    return _meshed_and_single(rank, meshes["chains"], run)


def s_pooled(rank, meshes):
    job = kt.MCJob(_std_target(), kt.MALA(driftstep=0.1), kt.MCRange(n_steps=3000, burnin=1500),
                   tuner=kt.AcceptanceRateTuner(0.6), n_chains=32, mesh=meshes["chains"],
                   pooled_tuning=True)
    chain = job.run(_gen(0), torch.zeros(2))
    return {"step": chain.final_state.tune.step, "rate": kt.stats.acceptance(chain)}


def s_shard(rank, meshes):
    from klara_tpu_torch.parallel import shard_chains

    tree = {"a": torch.arange(48.0).reshape(16, 3), "b": torch.arange(16.0), "c": torch.tensor(2.0)}
    return shard_chains(tree, meshes["chains"])


def _bivariate():
    from klara_tpu_torch.distributions import Normal

    def cond(other):
        return lambda v: Normal(v["rho"] * v[other], torch.sqrt(1 - v["rho"] ** 2))

    return kt.GenericModel([kt.Hyperparameter("rho"), kt.GibbsParameter("p1", setpdf=cond("p2")),
                            kt.GibbsParameter("p2", setpdf=cond("p1"))])


def _gibbs_record(out, collectives):
    return {"samples": out.samples, "final": out.final_values, "collectives": collectives,
            "carried": {k: tuple(v.shape) for k, v in out.final_values.items()}}


def s_gibbs(rank, meshes):
    """The bivariate Gibbs job on the mesh and alone; and a one-process run
    resumed on the mesh (each rank cuts its block of the final values once)
    against the one process's resume."""
    v0 = {"rho": torch.tensor(0.8), "p1": 0.0, "p2": 0.0}

    def job(mesh):
        return kt.GibbsJob(_bivariate(), {}, kt.MCRange(n_steps=400, burnin=100), n_chains=16,
                           mesh=mesh, device="cpu")

    def run(mesh):
        return _gibbs_record(*_collectives_of(lambda: job(mesh).run(_gen(3), v0)))

    out = _meshed_and_single(rank, meshes["chains"], run)
    alone = job(None).run(_gen(3), v0)
    out["resumed"] = _gibbs_record(*_collectives_of(
        lambda: job(meshes["chains"]).resume(_gen(4), alone, v0)))
    if rank == 0:
        out["resumed_single"] = job(None).resume(_gen(4), alone, v0).samples
    return out


def s_resume(rank, meshes):
    from klara_tpu_torch.parallel.mesh import chain_context, gather_chains, tree_map

    job = kt.MCJob(_std_target(), kt.MALA(driftstep=0.5), kt.MCRange(n_steps=300, burnin=100),
                   n_chains=16, mesh=meshes["chains"])
    chain = job.run(_gen(6), torch.zeros(2))
    resumed = job.resume(_gen(7), chain)
    # a reloaded checkpoint holds the global chains: each rank takes its block
    with chain_context(job._block):
        glob = tree_map(lambda x: gather_chains(x) if torch.is_tensor(x) and x.dim() else x,
                        chain.final_state)
    from_global = job.resume(_gen(7), kt.Chain({}, {}, glob))
    return {"shape": tuple(chain.value.shape), "resumed": resumed.value,
            "state_rows": {k: tuple(v.shape) for k, v in resumed.final_state._asdict().items()
                           if torch.is_tensor(v)},
            "from_global": from_global.value}


def _drawn_elements(fn):
    """``fn()`` and the elements of every keyed draw it made, with the first
    chain and the chain count of each draw's stream."""
    from klara_tpu_torch.ops import keyed

    seen, plain = [], keyed.draws_reference

    def record(stream, mode, shape, dtype, p0=None, p1=None):
        seen.append((stream.offset, stream.chains, int(np.prod(shape))))
        return plain(stream, mode, shape, dtype, p0, p1)

    keyed.draws_reference = record
    try:
        return fn(), seen
    finally:
        keyed.draws_reference = plain


DA = dict(tuner=kt.DualAveragingTuner(0.8, 10))
# every sampler of MCJob: (sampler, job keywords, steps, burnin)
DRAW_SITES = {
    "hmc_shared_jitter": (kt.HMC(leapstep=0.1, nleaps=5, jitter=0.5, jitter_style="step"), DA,
                          20, 10),
    "hmc_chain_jitter": (kt.HMC(leapstep=0.1, nleaps=5, jitter=0.5, jitter_style="chain"), DA,
                         20, 10),
    "nuts": (kt.NUTS(max_doublings=3), {}, 10, 5),
    "nuts_looped": (kt.NUTS(max_doublings=3, tree_impl="looped"), DA, 10, 5),
    "mala": (kt.MALA(0.8), {}, 20, 5),
    "smmala": (kt.SMMALA(0.5), {}, 10, 5),
    "mh": (kt.MH(sigma=1.0), {}, 20, 5),
    "mh_proposal": (None, {}, 20, 5),
    "ram": (kt.RAM(), {}, 20, 5),
    "am": (kt.AM(t0=5), {}, 20, 5),
    "amwg": (kt.AMWG(lower=-3.0, upper=3.0), {}, 10, 5),
    "slice": (kt.SliceSampler(), {}, 5, 2),
    "ars": (kt.ARS(logproposal=lambda x: -0.125 * (x * x).sum(-1), proposalscale=0.0), {}, 20,
            5),
    "prior_x0": (kt.MH(), {}, 20, 5),
}


def s_draw_sites(rank, meshes):
    """A few steps of every sampler, meshed and not, with each run's keyed
    draws' elements."""
    from klara_tpu_torch.distributions import LogNormal, Normal
    from klara_tpu_torch.models.examples import rats_gibbs_model

    gamma_target = kt.Target(logdensity_fn=lambda x: (torch.log(x) - x).sum(-1), dim=1)
    prior_target = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=3,
                             prior=Normal(0.0, 2.0))
    # an asymmetric proposal distribution
    proposal = kt.MH(proposal_fn=lambda x, s: LogNormal(torch.log(x), 0.5 * s[:, None]),
                     symmetric=False)
    out = {}
    for name, (sampler, kw, n, burnin) in DRAW_SITES.items():
        target = {"mh_proposal": gamma_target, "prior_x0": prior_target}.get(name, _std_target())

        def run(mesh):
            job = kt.MCJob(target, sampler or proposal, kt.MCRange(n_steps=n, burnin=burnin),
                           n_chains=16, mesh=mesh, device="cpu", **kw)
            x0 = {"prior_x0": None, "mh_proposal": torch.ones(1)}.get(name, torch.zeros(2))
            (chain, collectives), drawn = _drawn_elements(
                lambda: _collectives_of(lambda: job.run(_gen(11), x0)))
            return {"value": chain.value, "collectives": collectives,
                    "position": tuple(chain.final_state.position.shape), "drawn": drawn}

        out[name] = _meshed_and_single(rank, meshes["chains"], run)

    def rats(mesh):
        model, v0 = rats_gibbs_model(device="cpu")
        job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=20, burnin=5), n_chains=16, mesh=mesh)
        return _gibbs_record(*_collectives_of(lambda: job.run(_gen(12), v0)))

    out["rats_gibbs"] = _meshed_and_single(rank, meshes["chains"], rats)
    return out


def s_mismatch(rank, meshes):
    job = kt.MCJob(_std_target(), kt.MALA(0.5), kt.MCRange(n_steps=10, burnin=5), n_chains=16,
                   mesh=meshes["chains"])
    try:
        job.run(_gen(100 + rank), torch.zeros(2))
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _adapt_inputs(C=16, D=3):
    from klara_tpu_torch.samplers.base import Info

    g = _gen(0)
    pos = torch.randn(C, D, generator=g)
    sampler = kt.HMC(leapstep=0.1, nleaps=4)
    tuner = kt.DualAveragingTuner(0.8, 100)
    state = sampler.init(_std_target(), pos, g, step_size=0.1, tuner=tuner)
    state = state._replace(log_traj=torch.full((C,), 0.4), traj_m=torch.full((C,), 0.01),
                           traj_v=torch.full((C,), 0.002))
    stat = torch.rand(C, generator=g)
    infos = Info(accept=stat > 0.4, accept_stat=stat, logtarget=state.logtarget,
                 extras={"x_prop": pos + 0.3 * torch.randn(C, D, generator=g),
                         "p_end": torch.randn(C, D, generator=g),
                         "traj_frac": 0.5 + torch.rand(C, generator=g)})
    prev = pos - 0.2 * torch.randn(C, D, generator=g)
    return tuner, state, infos, prev


def _adapt_all(tuner, state, infos, prev, block):
    from klara_tpu_torch.jobs.job import chees_update, ensemble_cholesky, mass_update, tune_update
    from klara_tpu_torch.parallel.mesh import chain_context

    with chain_context(block):
        tuned = tune_update(tuner, state, infos, "accept_stat", True, 100)
        massed = mass_update(state, 49, 100, 50)
        chees = chees_update(state, prev, infos, 50, 0.9, 100, 0.1, 0.1, 64, 0.5)
        chol = ensemble_cholesky(state.position, 1e-6)
    return {"step": tuned.tune.step, "inv_mass": massed.inv_mass, "log_traj": chees.log_traj,
            "traj_m": chees.traj_m, "traj_v": chees.traj_v, "chol": chol}


def s_reductions(rank, meshes):
    from klara_tpu_torch.parallel.mesh import chain_block, tree_map

    tuner, state, infos, prev = _adapt_inputs()
    block = chain_block(meshes["chains"], "chains", 16)

    def local(x):
        return x[block.offset:block.offset + block.local] if torch.is_tensor(x) and x.dim() else x

    local_infos = infos._replace(accept=local(infos.accept), accept_stat=local(infos.accept_stat),
                                 logtarget=local(infos.logtarget),
                                 extras={k: local(v) for k, v in infos.extras.items()})
    out = {"meshed": _adapt_all(tuner, tree_map(local, state), local_infos, local(prev), block),
           "offset": block.offset, "local": block.local,
           "single": _adapt_all(tuner, state, infos, prev, None)}
    return out


def s_one_rank(rank, meshes):
    """A mesh whose chains dimension has one rank (each rank alone in its
    chains group) against no mesh: ChEES HMC with pooled tuning and ensemble
    mass, and the ensemble Cholesky, bit for bit."""
    from klara_tpu_torch.jobs.job import ensemble_cholesky
    from klara_tpu_torch.parallel.mesh import chain_block, chain_context

    def run(mesh):
        sampler = kt.HMC(leapstep=0.1, nleaps=4, trajectory_length=0.5, jitter=0.5,
                         jitter_style="step", max_nleaps=64)
        job = kt.MCJob(_std_target(), sampler, kt.MCRange(n_steps=60, burnin=40),
                       tuner=kt.DualAveragingTuner(0.8, 40), n_chains=16, pooled_tuning=True,
                       mass_adaptation=True, mass_period=10, traj_adaptation=True, mesh=mesh)
        chain = job.run(_gen(21), 0.1 * torch.randn(16, 2, generator=_gen(22)))
        return {"value": chain.value, "eps": chain.final_state.tune.step,
                "log_traj": chain.final_state.log_traj, "inv_mass": chain.final_state.inv_mass}

    before = _collectives()["all_reduce"]
    meshed = run(meshes["one_rank"])
    reduces = _collectives()["all_reduce"] - before
    x = torch.randn(64, 4, generator=_gen(23))
    with chain_context(chain_block(meshes["one_rank"], "chains", 64)):
        chol = ensemble_cholesky(x, 1e-6)
    return {"meshed": meshed, "single": run(None), "all_reduces": reduces, "chol": chol,
            "chol_single": ensemble_cholesky(x, 1e-6)}


def s_cholesky(rank, meshes):
    from klara_tpu_torch.jobs.job import ensemble_cholesky
    from klara_tpu_torch.parallel.mesh import chain_block, chain_context

    x = 2.0 * torch.randn(64, 4, generator=_gen(31)) + torch.arange(4.0)
    block = chain_block(meshes["chains"], "chains", 64)
    with chain_context(block):
        chol = ensemble_cholesky(x[block.offset:block.offset + block.local], 1e-6)
    return {"x": x, "chol": chol}


def s_precond(rank, meshes):
    """``run_preconditioned`` at a small size on the two-rank chains mesh, on
    a one-rank mesh and, on rank 0, without a mesh.

    With the main path's settings (ChEES stage 1, pooled dual averaging,
    ensemble mass, stage 2 whitened) the sum order of the reductions moves
    the bits, and HMC's jittered leap counts and accept decisions carry a
    change of 1e-7 to O(1) within a few dozen steps, so only the one-rank
    mesh is held to the mesh-less run.  With per-chain dual averaging the
    ensemble Cholesky factor is the run's one reduction: stage 1 on two
    ranks is the one process's bit for bit, and stage 2 is held to a
    one-process stage 2 from the same factor (``plain_given_chol``)."""
    from klara_tpu_torch.core.target import whiten_target
    from klara_tpu_torch.jobs.job import ensemble_cholesky
    from klara_tpu_torch.models.examples import synthetic_logistic_regression

    target, _, _ = synthetic_logistic_regression(dim=5, n_data=100, device="cpu")
    x0 = 0.1 * torch.randn(16, 5, generator=_gen(41))
    stage2_step = 5 ** -0.25

    def job(mesh, main, target=target, sampler=None, mcrange=kt.MCRange(n_steps=60, burnin=40),
            **kw):
        s1 = kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5 if main else None,
                    jitter=0.9, jitter_style="step", max_nleaps=256)
        return kt.MCJob(target, sampler or s1, mcrange, tuner=kt.DualAveragingTuner(0.8, 40),
                        n_chains=16, monitor=("value",), pooled_tuning=main,
                        mass_adaptation=main, mass_period=10, traj_adaptation=main,
                        mesh=mesh, **kw)

    def stage2_sampler(main):
        return kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=2.0 if main else None,
                      jitter=0.9, jitter_style="step", max_nleaps=64)

    def run(mesh, main):
        chain, _, info = job(mesh, main).run_preconditioned(
            _gen(42), x0, back_transform=False,
            stage2_replace=dict(sampler=stage2_sampler(main), traj_adaptation=False))
        return {"value": chain.value, "chol": info["chol"], "eps": chain.final_state.tune.step,
                "stage1_position": info["stage1_state"].position,
                "stage1_eps": info["stage1_state"].tune.step}

    out = {"main_meshed": run(meshes["chains"], True),
           "main_one_rank": run(meshes["one_rank"], True),
           "plain_meshed": run(meshes["chains"], False)}
    if rank == 0:
        out["main_single"] = run(None, True)
        # run_preconditioned's two stages by hand in one process, stage 2
        # from the two ranks' factor
        gen, chol = _gen(42), out["plain_meshed"]["chol"]
        c1, _ = job(None, False, mcrange=kt.MCRange(n_steps=41, burnin=40)).run_phased(gen, x0)
        x_end = c1.value[-1]
        y0 = torch.linalg.solve_triangular(chol, x_end.T, upper=False).T
        c2, _ = job(None, False, sampler=stage2_sampler(False), step_size=stage2_step,
                    target=whiten_target(target, chol)).run_phased(gen, y0)
        out["plain_given_chol"] = {"value": c2.value, "eps": c2.final_state.tune.step,
                                   "stage1_position": c1.final_state.position,
                                   "stage1_eps": c1.final_state.tune.step,
                                   "chol": ensemble_cholesky(x_end, 1e-6)}
    return out


def s_mesh2d(rank, meshes):
    from klara_tpu_torch.parallel import mesh2d

    m = mesh2d(1, 2, device="cpu")
    try:
        mesh2d(2, 2, device="cpu")
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"names": tuple(m.mesh_dim_names), "shape": tuple(m.mesh.shape), "raised": raised}


def _dir_bytes(path):
    """{file name: bytes} of every file under ``path``."""
    return {os.path.relpath(os.path.join(d, f), path): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(path) for f in files}


def s_csv(rank, meshes):
    """csv output on the two-rank mesh and, on rank 0, in one process: the
    MCJob stream across a ``resume`` (chunks of 7 that do not divide the
    run), its ``'post'`` mode, and a Gibbs job's csv variable across a
    ``resume``; rank 0 reads back every file, rank 1 reports its writers."""
    def mcjob(mesh, path, mode):
        job = kt.MCJob(_std_target(), kt.MALA(0.5), kt.MCRange(n_steps=40, burnin=10,
                                                                thinning=2),
                       n_chains=16, destination="csv", filepath=path, stream_chunk=7,
                       stream_mode=mode, mesh=mesh, device="cpu")
        chain = job.run(_gen(8), torch.zeros(2))
        if mode == "io_callback":
            job.resume(_gen(9), chain)
        return job._writer is not None

    def gibbs(mesh, path):
        v0 = {"rho": torch.tensor(0.8), "p1": 0.0, "p2": 0.0}
        job = kt.GibbsJob(_bivariate(), {}, kt.MCRange(n_steps=30, burnin=10), n_chains=16,
                          outopts={"p1": {"destination": "csv", "filepath": path}},
                          stream_chunk=7, mesh=mesh, device="cpu")
        job.resume(_gen(4), job.run(_gen(3), v0), v0)
        return bool(job._writers)

    runs = {"mcjob_stream": lambda m, p: mcjob(m, p, "io_callback"),
            "mcjob_post": lambda m, p: mcjob(m, p, "post"), "gibbs": gibbs}
    out = {}
    for name, fn in runs.items():
        path = os.path.join(WORKER_DIR, "csv", name)
        rec = {"writes": fn(meshes["chains"], os.path.join(path, "meshed"))}
        if rank == 0:
            fn(None, os.path.join(path, "single"))
            rec["meshed"] = _dir_bytes(os.path.join(path, "meshed"))
            rec["single"] = _dir_bytes(os.path.join(path, "single"))
        out[name] = rec
    return out


def s_param_target(rank, meshes):
    """The param-sharded target on the (chains, param) mesh: value and
    gradient on this rank's chains, one (1, D) position eagerly, the
    indivisible D, and an HMC job with per-chain leap counts."""
    from klara_tpu_torch.parallel import param_sharded_logreg_target
    from klara_tpu_torch.parallel.mesh import chain_block

    mesh = meshes["2d"]
    X, y = _logreg_problem()
    D = X.shape[1]
    target = param_sharded_logreg_target(X, y, mesh, prior_var=10.0)
    P = torch.as_tensor(np.random.default_rng(0).standard_normal((8, D)), dtype=torch.float32)
    block = chain_block(mesh, "chains", 8)
    value, grad = target.logdensity_and_grad(P[block.offset:block.offset + block.local])
    p = torch.linspace(-0.5, 0.5, D)[None]
    v1, g1 = target.logdensity_and_grad(p)
    try:
        param_sharded_logreg_target(*_logreg_problem(D=15), mesh)
        indivisible = None
    except ValueError as e:
        indivisible = str(e)

    # per-chain jitter of the trajectory length (and dual averaging per
    # chain): per-chain leap counts
    sampler = kt.HMC(leapstep=0.05, nleaps=4, trajectory_length=1.0, jitter=0.5,
                     jitter_style="chain")
    job = kt.MCJob(target, sampler,
                   kt.MCRange(n_steps=300, burnin=100), tuner=kt.DualAveragingTuner(0.8, 100),
                   n_chains=16, mesh=mesh, diagnostics=("accept", "nleaps"))
    chain = job.run(_gen(0), torch.zeros(D))
    leaps = chain["nleaps"]
    return {"offset": block.offset, "value": value, "grad": grad, "v1": v1, "g1": g1,
            "indivisible": indivisible, "finite": bool(torch.isfinite(chain.value).all()),
            "mean": kt.stats.mean(chain), "rate": kt.stats.acceptance(chain),
            "steps_with_mixed_leaps": int((leaps.max(1).values != leaps.min(1).values).sum())}


def _meshes(world):
    from klara_tpu_torch.parallel import chain_mesh, mesh2d
    from klara_tpu_torch.parallel.mesh import build_mesh

    if world == 2:
        return {"chains": chain_mesh(device="cpu"),
                "one_rank": build_mesh((2, 1), ("x", "chains"), device="cpu")}
    return {"2d": mesh2d(2, 2, device="cpu")}


SCENARIOS = {
    2: {"mala": s_mala, "pooled": s_pooled, "shard": s_shard, "gibbs": s_gibbs,
        "resume": s_resume, "draw_sites": s_draw_sites, "mismatch": s_mismatch,
        "reductions": s_reductions, "one_rank": s_one_rank, "cholesky": s_cholesky,
        "precond": s_precond, "csv": s_csv, "mesh2d": s_mesh2d},
    4: {"param_target": s_param_target},
}


WORKER_DIR = None  # a worker's output directory, shared by its ranks


def worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist

    from klara_tpu_torch.parallel import initialize_distributed

    global WORKER_DIR
    WORKER_DIR = out_dir
    torch.set_num_threads(1)
    initialize_distributed("file://" + init_file, world, rank, device="cpu")
    meshes = _meshes(world)
    results = {}
    for name, fn in SCENARIOS[world].items():
        try:
            results[name] = fn(rank, meshes)
        except Exception:  # recorded per scenario; the test of that scenario fails
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ------------------------------------------------------------ the spawning
def spawn_group(world: int, tmp, script: str = __file__):
    """Run ``script``'s worker on ``world`` gloo CPU ranks; every rank's
    results, in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    init_file = os.path.join(str(tmp), "pg")
    procs = [subprocess.Popen([sys.executable, script, "worker", str(r), str(world), init_file,
                               str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn_group(2, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return spawn_group(4, tmp_path_factory.mktemp("four_ranks"))


def _part(results, name):
    parts = [r[name] for r in results]
    for rank, part in enumerate(parts):
        if isinstance(part, dict) and "error" in part:
            pytest.fail(f"rank {rank}, scenario {name}:\n{part['error']}")
    return parts


def _cat(parts, key, dim=1):
    return torch.cat([p["meshed"][key] for p in parts], dim)


# ----------------------------------------------- counterparts of test_parallel
def test_determinism_across_shardings(two):
    parts = _part(two, "mala")
    torch.testing.assert_close(_cat(parts, "value"), parts[0]["single"]["value"],
                               rtol=0, atol=0)


def test_pooled_tuning_identical_across_chains(two):
    parts = _part(two, "pooled")
    steps = torch.cat([p["step"] for p in parts])
    assert steps.shape == (32,)
    assert bool((steps == steps[0]).all())
    rates = [float(p["rate"]) for p in parts]
    assert rates[0] == rates[1]
    assert abs(rates[0] - 0.6) < 0.08


def test_per_chain_tuning_differs():
    job = kt.MCJob(_std_target(), kt.MALA(driftstep=0.1), kt.MCRange(n_steps=2000, burnin=1000),
                   tuner=kt.AcceptanceRateTuner(0.6), n_chains=8, device="cpu")
    chain = job.run(_gen(1), torch.zeros(2))
    steps = chain.final_state.tune.step
    assert len(torch.unique(steps)) > 1


def test_shard_chains_helper(two):
    parts = _part(two, "shard")
    for rank, part in enumerate(parts):
        rows = slice(8 * rank, 8 * rank + 8)
        torch.testing.assert_close(part["a"], torch.arange(48.0).reshape(16, 3)[rows])
        torch.testing.assert_close(part["b"], torch.arange(16.0)[rows])
        assert part["c"].dim() == 0


def test_mesh2d_shapes(two):
    """mesh2d(1, 2) on two ranks has the named dimensions; a mesh that needs
    more ranks than the group holds raises ValueError."""
    for part in _part(two, "mesh2d"):
        assert part["names"] == ("chains", "param")
        assert part["shape"] == (1, 2)
        assert part["raised"] == "mesh 2x2 needs 4 ranks, have 2"


def test_param_sharded_target_matches_unsharded(four):
    """Sharded value+grad on a 2 x 2 mesh == the plain value+grad, and an HMC
    job with per-chain leap counts on that mesh finishes and mixes."""
    from klara_tpu_torch.ops.logreg import logreg_value_grad_reference

    parts = _part(four, "param_target")
    X, y = (torch.as_tensor(a) for a in _logreg_problem())
    P = torch.as_tensor(np.random.default_rng(0).standard_normal((8, 16)), dtype=torch.float32)
    v_ref, g_ref = logreg_value_grad_reference(P, X, X.T @ y, 10.0)
    for part in parts:
        rows = slice(part["offset"], part["offset"] + 4)
        torch.testing.assert_close(part["value"], v_ref[rows], rtol=PARITY_RTOL, atol=PARITY_ATOL)
        torch.testing.assert_close(part["grad"], g_ref[rows], rtol=PARITY_RTOL, atol=PARITY_ATOL)
    for part in parts:
        assert part["finite"]
        assert float(part["rate"]) > 0.3
        assert part["steps_with_mixed_leaps"] > 0
        assert torch.equal(part["mean"], parts[0]["mean"])
        assert float(part["rate"]) == float(parts[0]["rate"])


def test_param_sharded_target_direct_unbatched_call(four):
    """One chain, a (1, D) position, evaluated eagerly on a mesh whose chains
    dimension has two ranks."""
    from klara_tpu_torch.ops.logreg import logreg_value_grad_reference

    X, y = (torch.as_tensor(a) for a in _logreg_problem())
    p = torch.linspace(-0.5, 0.5, 16)[None]
    v_ref, g_ref = logreg_value_grad_reference(p, X, X.T @ y, 10.0)
    for part in _part(four, "param_target"):
        torch.testing.assert_close(part["v1"], v_ref, rtol=PARITY_RTOL, atol=PARITY_ATOL)
        torch.testing.assert_close(part["g1"], g_ref, rtol=PARITY_RTOL, atol=PARITY_ATOL)


def test_param_sharded_target_indivisible_dim_errors(four):
    import jax

    from klara_tpu.parallel import mesh2d as jmesh2d
    from klara_tpu.parallel import param_sharded_logreg_target as jtarget

    for part in _part(four, "param_target"):
        assert part["indivisible"] is not None and "not divisible" in part["indivisible"]
    X, y = _logreg_problem(D=15)
    with pytest.raises(ValueError, match="not divisible"):
        jtarget(jax.numpy.asarray(X), jax.numpy.asarray(y), jmesh2d(4, 2))


def _assert_rank_blocks_without_collectives(parts, run="meshed", chains=16):
    """Each rank carried its n_chains / 2 chains, and its run issued no
    collective but the generator check (one all-gather of one digest a
    rank)."""
    for part in parts:
        rec = part[run]
        assert all(shape[0] == chains // 2 for shape in rec["carried"].values()), rec["carried"]
        assert all(v.shape[1] == chains // 2 for v in rec["samples"].values())
        assert rec["collectives"] == {"all_reduce": 0, "all_gather": 1, "gathered_elements": 2}


def test_gibbs_determinism_across_shardings(two):
    parts = _part(two, "gibbs")
    for key in ("p1", "p2"):
        torch.testing.assert_close(torch.cat([p["meshed"]["samples"][key] for p in parts], 1),
                                   parts[0]["single"]["samples"][key], rtol=0, atol=0)
    _assert_rank_blocks_without_collectives(parts)


def test_gibbs_resume_of_a_one_process_run_on_two_ranks(two):
    """A one-process chain resumed on two ranks: each rank cuts its block of
    the 16 chains' final values once, and the traces equal the one-process
    resume bit for bit."""
    parts = _part(two, "gibbs")
    for key in ("p1", "p2"):
        torch.testing.assert_close(torch.cat([p["resumed"]["samples"][key] for p in parts], 1),
                                   parts[0]["resumed_single"][key], rtol=0, atol=0)
    _assert_rank_blocks_without_collectives(parts, "resumed")


# ------------------------------------------------ counterpart of test_hardening
def test_resume_under_mesh(two):
    parts = _part(two, "resume")
    for part in parts:
        assert tuple(part["resumed"].shape) == part["shape"] == (200, 8, 2)
        assert bool(torch.isfinite(part["resumed"]).all())
        # the restored state holds this rank's block of the chains
        assert part["state_rows"]["position"] == (8, 2)
        torch.testing.assert_close(part["from_global"], part["resumed"], rtol=0, atol=0)


# ------------------------------------------------------- the keyed streams
@pytest.mark.parametrize("site", sorted(DRAW_SITES))
def test_draw_rule_two_ranks_equal_one_process(two, site):
    """Every sampler's trace on two ranks is the one process's bit for bit,
    and its draws issue no collective: only the run's generator check."""
    parts = [p[site] for p in _part(two, "draw_sites")]
    got = torch.cat([p["meshed"]["value"] for p in parts], 1)
    torch.testing.assert_close(got, parts[0]["single"]["value"], rtol=0, atol=0)
    for part in parts:
        assert part["meshed"]["position"][0] == 8
        assert part["meshed"]["collectives"] == {"all_reduce": 0, "all_gather": 1,
                                                 "gathered_elements": 2}


@pytest.mark.parametrize("site", sorted(DRAW_SITES))
def test_a_rank_draws_only_its_own_chains(two, site):
    """Each rank's keyed draws name its 8 chains (the shared jitter global
    chain 0 alone), and a rank draws C/R of the one process's elements (the
    slice sampler's shrink loop, which runs as long as a rank's own chains
    need it, at most that)."""
    parts = [p[site] for p in _part(two, "draw_sites")]
    single = sum(n for _, _, n in parts[0]["single"]["drawn"])
    for rank, part in enumerate(parts):
        drawn = part["meshed"]["drawn"]
        assert {(off, c) for off, c, _ in drawn} <= {(8 * rank, 8), (0, 1)}
        mine = sum(n for off, c, n in drawn if c == 8)
        shared = sum(n for off, c, n in drawn if c == 1)
        if site == "slice":
            assert 0 < mine <= (single - shared) // 2
        else:
            assert 2 * mine == single - shared


def test_draw_rule_gibbs_conditionals(two):
    """The rats conditionals (Normal and InverseGamma draws from the keyed
    stream) on two ranks equal one process bit for bit; each rank carries
    its 8 chains and the sweeps issue no collective."""
    parts = [p["rats_gibbs"] for p in _part(two, "draw_sites")]
    for key, single in parts[0]["single"]["samples"].items():
        got = torch.cat([p["meshed"]["samples"][key] for p in parts], 1)
        torch.testing.assert_close(got, single, rtol=0, atol=0)
    for key, single in parts[0]["single"]["final"].items():
        got = torch.cat([p["meshed"]["final"][key] for p in parts])
        torch.testing.assert_close(got, single, rtol=0, atol=0)
    _assert_rank_blocks_without_collectives(parts)


def test_take_block_rejects_a_leaf_of_another_length():
    """A per-chain leaf holds the global chains or the rank's block; any
    other leading length raises instead of passing as a replicated leaf."""
    from klara_tpu_torch.parallel.mesh import ChainBlock, take_block

    block = ChainBlock(group=None, rank=1, size=2, total=16)
    state = {"position": torch.arange(32.0).reshape(16, 2), "step": torch.ones(8),
             "count": torch.tensor(3)}
    cut = take_block(state, block)
    torch.testing.assert_close(cut["position"], state["position"][8:], rtol=0, atol=0)
    assert cut["step"] is state["step"] and cut["count"] is state["count"]
    with pytest.raises(ValueError, match="neither the 16 chains nor this rank's 8"):
        take_block({"position": torch.zeros(16, 2), "grid": torch.zeros(5)}, block)


def test_generators_seeded_differently_raise(two):
    for part in _part(two, "mismatch"):
        assert part["raised"] is not None and "generators" in part["raised"]


@pytest.mark.parametrize("run", ["mcjob_stream", "mcjob_post", "gibbs"])
def test_csv_on_a_mesh_of_processes_writes_the_one_process_bytes(two, run):
    """Rank 0 gathers each chunk of the chains and alone writes: every file
    of the two ranks' directory is the one process's byte for byte."""
    parts = _part(two, "csv")
    if run != "mcjob_post":  # the stream's writer: on rank 0 alone
        assert [p[run]["writes"] for p in parts] == [True, False]
    rec = parts[0][run]
    assert rec["single"] and sorted(rec["meshed"]) == sorted(rec["single"])
    for name, data in rec["single"].items():
        assert rec["meshed"][name] == data, name


# ------------------------------------------------------------ the reductions
@pytest.mark.parametrize("key", ["step", "inv_mass", "log_traj", "traj_m", "traj_v", "chol"])
def test_reductions_two_ranks_match_one_process(two, key):
    for part in _part(two, "reductions"):
        rows = slice(part["offset"], part["offset"] + part["local"])
        want = part["single"][key]
        want = want[rows] if want.shape[0] == 16 else want
        torch.testing.assert_close(part["meshed"][key], want, rtol=RED_RTOL, atol=RED_ATOL)


def test_ensemble_cholesky_two_ranks_match_jax(two):
    """The mesh-aware ensemble Cholesky on two ranks against the JAX
    package's shrunk, ridged ensemble covariance of the whole batch
    (klara_tpu/jobs/job.py, run_preconditioned) and its factor."""
    import jax.numpy as jnp

    parts = _part(two, "cholesky")
    x = jnp.asarray(parts[0]["x"].numpy())
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    cov = (xc.T @ xc) / (x.shape[0] - 1)
    n, d = x.shape
    w = n / (n + d)
    cov = w * cov + (1.0 - w) * jnp.diag(jnp.diag(cov))
    lam = 1e-6 * jnp.mean(jnp.diag(cov)) + 1e-12
    chol = np.asarray(jnp.linalg.cholesky(cov + lam * jnp.eye(d, dtype=cov.dtype)))
    for part in parts:
        np.testing.assert_allclose(part["chol"].numpy(), chol, rtol=1e-5, atol=1e-6)
        assert torch.equal(part["chol"], parts[0]["chol"])


def test_one_rank_mesh_equals_no_mesh(two):
    for part in _part(two, "one_rank"):
        assert part["all_reduces"] > 0  # the reductions ran their collectives
        for key, single in part["single"].items():
            torch.testing.assert_close(part["meshed"][key], single, rtol=0, atol=0)
        torch.testing.assert_close(part["chol"], part["chol_single"], rtol=0, atol=0)


# ------------------------------------------------------- run_preconditioned
def _ranks_cat(parts, run, key):
    return torch.cat([p[run][key] for p in parts], 1 if key == "value" else 0)


def test_run_preconditioned_two_ranks_match_one_process(two):
    """Per-chain dual averaging: stage 1 bit for bit, the ensemble Cholesky
    factor the same on both ranks and within the reductions' tolerance of
    one process's, and stage 2 (from the local y0 through the gathered
    start) bit for bit against one process's stage 2 from that factor."""
    parts = _part(two, "precond")
    single = parts[0]["plain_given_chol"]
    for key in ("stage1_position", "stage1_eps", "value", "eps"):
        torch.testing.assert_close(_ranks_cat(parts, "plain_meshed", key), single[key],
                                   rtol=0, atol=0)
    assert torch.equal(parts[0]["plain_meshed"]["chol"], parts[1]["plain_meshed"]["chol"])
    torch.testing.assert_close(parts[0]["plain_meshed"]["chol"], single["chol"],
                               rtol=RED_RTOL, atol=RED_ATOL)


def test_run_preconditioned_main_path_on_two_ranks(two):
    """The main path's settings on two ranks: a replicated factor, finite
    draws of every chain, and the one process's shapes."""
    parts = _part(two, "precond")
    single = parts[0]["main_single"]
    assert torch.equal(parts[0]["main_meshed"]["chol"], parts[1]["main_meshed"]["chol"])
    value = _ranks_cat(parts, "main_meshed", "value")
    assert value.shape == single["value"].shape == (20, 16, 5)
    assert bool(torch.isfinite(value).all())


def test_run_preconditioned_one_rank_mesh_equals_no_mesh(two):
    part = _part(two, "precond")[0]
    for key, want in part["main_single"].items():
        torch.testing.assert_close(part["main_one_rank"][key], want, rtol=0, atol=0)


# ------------------------------------------------------------ statistics
# elements each statistic all-gathers on the two ranks (150 draws, 16 chains,
# dim 2): sums are all-reduced; per-chain results are 16 x 2; split-R-hat's
# per-chain means and variances of both halves 2 x 2 x 16 x 2; only the
# rank-normalised R-hat gathers the 150 x 16 x 2 draws
GATHERED = {"mean": 0, "rate": 0, "ess": 0, "rhat": 128, "mean_pc": 32, "mcse": 32,
            "iact": 32, "ess_pc": 32, "rhat_rank": 4800}


@pytest.mark.parametrize("stat", sorted(GATHERED))
def test_meshed_statistics_are_global_on_every_rank(two, stat):
    parts = _part(two, "mala")
    assert torch.equal(parts[0]["meshed"][stat], parts[1]["meshed"][stat])
    torch.testing.assert_close(parts[0]["meshed"][stat], parts[0]["single"][stat],
                               rtol=1e-5, atol=1e-6)
    for part in parts:
        assert part["meshed"]["gathered"][stat] == GATHERED[stat]


# ------------------------------------------------------------ JAX parity
def test_param_sharded_target_matches_jax(four):
    """The port's value+grad on the 2 x 2 mesh against JAX's
    param_sharded_logreg_target on mesh2d(4, 2), the same inputs."""
    import jax

    from klara_tpu.parallel import mesh2d as jmesh2d
    from klara_tpu.parallel import param_sharded_logreg_target as jtarget

    X, y = _logreg_problem()
    P = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    jt = jtarget(jax.numpy.asarray(X), jax.numpy.asarray(y), jmesh2d(4, 2), prior_var=10.0)
    jv, jg = (np.asarray(a) for a in jax.jit(jax.vmap(jt.logdensity_and_grad))(P))
    for part in _part(four, "param_target"):
        rows = slice(part["offset"], part["offset"] + 4)
        np.testing.assert_allclose(part["value"].numpy(), jv[rows], rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        np.testing.assert_allclose(part["grad"].numpy(), jg[rows], rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)


# ------------------------------------------------------------ device rules
def test_chain_mesh_without_card_raises():
    """No card and no device="cpu": the mesh is refused, no gloo/CPU group is
    built in its place."""
    import torch.distributed as dist

    from klara_tpu_torch.parallel import chain_mesh, mesh2d

    if torch.cuda.is_available():
        pytest.skip("a card is present: the rule is about its absence")
    for make in (chain_mesh, mesh2d):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert not dist.is_initialized()


def test_parallel_imports_no_jax():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|klara_tpu)(\.|\s|$)", re.M)
    folder = os.path.join(REPO, "klara_tpu_torch", "parallel")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            with open(os.path.join(folder, name)) as f:
                assert not pattern.search(f.read()), name


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
