"""The jobs' output on the CPU: counterparts of the JAX package's tests of
Gibbs csv outopts (tests/test_gibbs.py), verbose progress and the scalar
resume (tests/test_hardening.py) and of run_phased refusing csv
(tests/test_phased.py); ``MCJob.resume`` reruns burnin with adaptation as
the JAX job does; a writer that cannot write raises; ``trace_profile``."""

import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt

import klara_tpu_torch as kt
from klara_tpu_torch import distributions as td
from klara_tpu_torch.io import read_chain, read_chain_csv
from klara_tpu_torch.utils import trace_profile

PROGRESS = re.compile(r"^\[target\] (burnin |sampling) iteration (\d+): \d+\.\d\d % acceptance rate$")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _normal(dim):
    return kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=dim)


def _bvn_model(rho=0.8):
    def cond(other):
        return lambda v: td.Normal(v["rho"] * v[other], torch.sqrt(1 - v["rho"] ** 2))

    return kt.GenericModel([kt.Hyperparameter("rho"), kt.GibbsParameter("p1", setpdf=cond("p2")),
                            kt.GibbsParameter("p2", setpdf=cond("p1"))])


V0 = {"rho": 0.8, "p1": 0.0, "p2": 0.0}


# ---------------------------------------------------------------- Gibbs csv
def test_gibbs_per_variable_outopts(tmp_path):
    """p1 streams to csv during the run, p2 keeps no trace."""
    out = str(tmp_path / "p1_stream")
    job = kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=400, burnin=100), n_chains=4,
                      outopts={"p1": {"destination": "csv", "filepath": out},
                               "p2": {"destination": "none"}}, device="cpu")
    chains = job.run(_gen(6), V0)
    assert "p2" not in chains.samples and "p2" in chains.final_values
    rows = np.loadtxt(os.path.join(out, "p1.csv"), delimiter=",")
    assert rows.shape == (300, 4) and np.isfinite(rows).all()


def test_gibbs_csv_streaming_across_resume(tmp_path):
    """The writers persist across run and resume, so the resume appends its
    segment; the streamed draws of p1 and the nstate draws of p2 equal an
    all-nstate twin's of the same seed bit for bit, run and resume alike."""
    out = str(tmp_path / "stream")
    kw = dict(model=_bvn_model(), sweep={}, mcrange=kt.MCRange(n_steps=300, burnin=100),
              n_chains=4, device="cpu")
    job = kt.GibbsJob(**kw, outopts={"p1": {"destination": "csv", "filepath": out}},
                      stream_chunk=64)
    twin = kt.GibbsJob(**kw)
    g, gt = _gen(11), _gen(11)
    first, first_t = job.run(g, V0), twin.run(gt, V0)
    assert read_chain_csv(out)["p1"].shape == (200, 4)
    second, second_t = job.resume(g, first, V0), twin.resume(gt, first_t, V0)
    back = read_chain(out, device="cpu")["p1"]
    assert back.shape == (400, 4)
    assert torch.equal(back[:200].float(), first_t.samples["p1"])
    assert torch.equal(back[200:].float(), second_t.samples["p1"])
    assert torch.equal(second.samples["p2"], second_t.samples["p2"])
    for k in ("p1", "p2"):
        assert torch.equal(second.final_values[k], second_t.final_values[k])


# ------------------------------------------------------------ MCJob output
def test_verbose_progress_reports(capsys):
    """One line every progress_period steps, in the JAX package's format,
    from run, both phases of run_phased and resume."""
    def lines():
        return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]

    job = kt.MCJob(_normal(2), kt.MH(), kt.MCRange(n_steps=200, burnin=100), n_chains=4,
                   verbose=True, progress_period=50, device="cpu")
    chain = job.run(_gen(5), torch.zeros(2))
    out = lines()
    assert [PROGRESS.match(ln).groups() for ln in out] == [
        ("burnin ", "50"), ("burnin ", "100"), ("sampling", "150"), ("sampling", "200")]
    job.run_phased(_gen(5), torch.zeros(2))
    assert len(lines()) == 4
    job.resume(_gen(6), chain)
    assert len(lines()) == 4

    jjob = jkt.MCJob(jkt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(x * x), dim=2),
                     jkt.MH(), jkt.MCRange(n_steps=200, burnin=100), n_chains=4, verbose=True,
                     progress_period=50)
    jax.block_until_ready(jjob.run(jax.random.key(5), jnp.zeros(2)).final_state)
    jax.effects_barrier()
    jout = lines()
    assert [ln.split(":")[0] for ln in jout] == [ln.split(":")[0] for ln in out]
    assert all(PROGRESS.match(ln) for ln in jout)

    job.verbose = False
    job.run(_gen(5), torch.zeros(2))
    assert lines() == []


def test_univariate_resume_squeezes():
    target = kt.Target(logdensity_fn=lambda x: -0.5 * x**2, dim=1)
    job = kt.MCJob(target, kt.MALA(0.9), kt.MCRange(n_steps=300, burnin=100), n_chains=4,
                   device="cpu")
    chain = job.run(_gen(0), torch.tensor(0.0))
    resumed = job.resume(_gen(1), chain)
    assert chain.value.shape == (200, 4)
    assert resumed.value.shape == (200, 4)


def test_resume_reruns_burnin_with_adaptation_as_jax():
    """resume runs mcrange.n_steps steps with the tuner updated at every one
    and draws saved after burnin, from the final state; the dual-averaging
    count says so in both packages."""
    rng = kt.MCRange(n_steps=60, burnin=20)
    job = kt.MCJob(_normal(2), kt.MALA(0.5), rng, tuner=kt.DualAveragingTuner(0.574, 1000),
                   n_chains=4, device="cpu")
    chain = job.run(_gen(0), torch.zeros(2))
    resumed = job.resume(_gen(1), chain)
    jjob = jkt.MCJob(jkt.Target(logdensity_fn=lambda x: -0.5 * jnp.sum(x * x), dim=2),
                     jkt.MALA(0.5), jkt.MCRange(n_steps=60, burnin=20),
                     tuner=jkt.DualAveragingTuner(0.574, 1000), n_chains=4)
    jchain = jjob.run(jax.random.key(0), jnp.zeros(2))
    jresumed = jjob.resume(jax.random.key(1), jchain)
    counts = [c.final_state.tune.extra.count.tolist() for c in (chain, resumed)]
    jcounts = [np.asarray(c.final_state.tune.extra.count).tolist() for c in (jchain, jresumed)]
    assert counts == jcounts == [[60] * 4, [120] * 4]
    assert resumed.value.shape == chain.value.shape == tuple(jresumed.value.shape) == (40, 4, 2)
    assert not torch.equal(resumed.final_state.tune.step, chain.final_state.tune.step)


@pytest.mark.parametrize("method", ["run_phased", "run_preconditioned"])
def test_run_phased_rejects_csv(tmp_path, method):
    job = kt.MCJob(_normal(3), kt.HMC(leapstep=0.1, nleaps=8), kt.MCRange(n_steps=50, burnin=20),
                   n_chains=8, monitor=("value",), destination="csv",
                   filepath=str(tmp_path / "out"), device="cpu")
    with pytest.raises(ValueError, match="nstate"):
        getattr(job, method)(_gen(0), torch.zeros(3))


@pytest.mark.parametrize("job", ["mcjob", "gibbs"])
def test_csv_writer_error_raises(tmp_path, job):
    """A filepath that names a file: the run raises instead of dropping the
    draws."""
    bad = tmp_path / "file"
    bad.write_text("")
    with pytest.raises(OSError):
        if job == "mcjob":
            kt.MCJob(_normal(2), kt.MH(), kt.MCRange(n_steps=20, burnin=5), n_chains=2,
                     destination="csv", filepath=str(bad), device="cpu").run(_gen(), torch.zeros(2))
        else:
            kt.GibbsJob(_bvn_model(), {}, kt.MCRange(n_steps=20, burnin=5), n_chains=2,
                        outopts={"p1": {"destination": "csv", "filepath": str(bad)}},
                        device="cpu").run(_gen(), V0)


def test_trace_profile_times_and_exports(tmp_path, capsys):
    job = kt.MCJob(_normal(2), kt.MH(), kt.MCRange(n_steps=20, burnin=5), n_chains=2,
                   device="cpu")
    with trace_profile(label="plain"):
        job.run(_gen(), torch.zeros(2))
    with trace_profile(str(tmp_path / "tr"), label="run"):
        job.run(_gen(), torch.zeros(2))
    out = capsys.readouterr().out
    assert re.search(r"^\[plain\] \d+\.\d{3}s$", out, re.M)
    assert re.search(r"^\[run\] \d+\.\d{3}s \(trace: ", out, re.M)
    with open(tmp_path / "tr" / "run.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
