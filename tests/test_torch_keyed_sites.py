"""Every draw of an ``MCJob`` and of a nested Gibbs block is a keyed draw
(``klara_tpu_torch.ops.keyed``), the counterpart of the JAX package's
per-chain keys (``chain_keys = split(run_key, n_chains)`` folded with the
step, klara_tpu/jobs/job.py):

* no two draws of a run share a counter (step, site, part): two steps of
  each sampler of the zoo, with the init draws (a start from the prior, the
  step-size search's momentum) and the shared jitter, and two sweeps of a
  Gibbs job with nested HMC, slice and MH blocks beside a conditional;
* the sites lie in their regions of ``ops.keyed``'s table: MCJob's window
  [``JOB_SITES``, ``MH_SITE``], the nested blocks' windows
  [``NESTED_SITES``, ``JOB_SITES``), the Gibbs blocks below;
* ``samplers/`` and ``jobs/`` draw nothing from a ``torch.Generator`` but
  the run key (``ops.keyed.run_key``);
* a sampler called without a job keys a stream from its generator at each
  call, so tests and examples that call ``step`` directly keep working.
"""

from __future__ import annotations

import os
import re

import pytest
import torch

import klara_tpu_torch as kt
from klara_tpu_torch import distributions as td
from klara_tpu_torch.ops import keyed
from klara_tpu_torch.ops.keyed import JOB_SITES, MH_SITE, NESTED_SITES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _std(dim=2, prior=None):
    return kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=dim, prior=prior)


def _gamma():
    return kt.Target(logdensity_fn=lambda x: (torch.log(x) - x).sum(-1), dim=1)


DA = dict(tuner=kt.DualAveragingTuner(0.8, 10))
# name: (target, sampler, job keywords, x0)
SAMPLERS = {
    "hmc_shared_jitter": (_std(), kt.HMC(leapstep=0.1, nleaps=5, jitter=0.5, jitter_style="step"),
                          DA, torch.zeros(2)),
    "hmc_chain_jitter": (_std(), kt.HMC(leapstep=0.1, nleaps=5, jitter=0.5,
                                        jitter_style="chain"), DA, torch.zeros(2)),
    "nuts_static": (_std(), kt.NUTS(max_doublings=3, tree_impl="static"), DA, torch.zeros(2)),
    "nuts_looped": (_std(), kt.NUTS(max_doublings=3, tree_impl="looped"), {}, torch.zeros(2)),
    "mala": (_std(), kt.MALA(0.5), {}, torch.zeros(2)),
    "smmala": (_std(), kt.SMMALA(0.5), {}, torch.zeros(2)),
    "mh": (_std(), kt.MH(1.0), {}, torch.zeros(2)),
    "mh_proposal": (_gamma(), kt.MH(proposal_fn=lambda x, s: td.LogNormal(torch.log(x),
                                                                          0.5 * s[:, None]),
                                    symmetric=False), {}, torch.ones(1)),
    "ram": (_std(), kt.RAM(), {}, torch.zeros(2)),
    "am": (_std(), kt.AM(t0=1), {}, torch.zeros(2)),
    "amwg": (_std(), kt.AMWG(lower=-3.0, upper=3.0), {}, torch.zeros(2)),
    "slice": (_std(), kt.SliceSampler(max_shrinks=20), {}, torch.zeros(2)),
    "ars": (_std(), kt.ARS(logproposal=lambda x: -0.125 * (x * x).sum(-1), proposalscale=0.0),
            {}, torch.zeros(2)),
    "prior_x0": (_std(3, td.Normal(0.0, 2.0)), kt.MH(), {}, None),
}


@pytest.fixture
def recorded(monkeypatch):
    """Every keyed draw's (step, site, part, first chain, chains, shape), in
    the order the plain version was asked for them."""
    seen = []
    plain = keyed.draws_reference

    def record(stream, mode, shape, dtype, p0=None, p1=None):
        seen.append((int(stream.step), stream.site, stream.part, stream.offset, stream.chains,
                     tuple(shape)))
        return plain(stream, mode, shape, dtype, p0, p1)

    monkeypatch.setattr(keyed, "draws_reference", record)
    return seen


def _counters(seen):
    return [(step, site, part) for step, site, part, *_ in seen]


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_no_two_draws_of_a_run_share_a_counter(name, recorded):
    """Two steps and the init of each sampler: every draw at a counter of its
    own, in MCJob's window, at step 0 or 1, over the job's 8 chains (the
    shared jitter over global chain 0 alone)."""
    target, sampler, kw, x0 = SAMPLERS[name]
    job = kt.MCJob(target, sampler, kt.MCRange(n_steps=2, burnin=1), n_chains=8, device="cpu",
                   **kw)
    chain = job.run(torch.Generator().manual_seed(1), x0)
    assert bool(torch.isfinite(chain.value).all())
    counters = _counters(recorded)
    assert recorded and len(counters) == len(set(counters)), counters
    assert {step for step, *_ in counters} <= {0, 1}
    assert all(JOB_SITES <= site <= MH_SITE for _, site, _ in counters)
    for step, site, part, offset, chains, shape in recorded:
        if site == MH_SITE - keyed.SHARED_JITTER:
            assert (offset, chains, shape) == (0, 1, (1,))
        else:
            assert (offset, chains, shape[0]) == (0, 8, 8)
    steps = [step for step, site, *_ in recorded
             if site not in (MH_SITE - keyed.INIT_MOMENTUM, MH_SITE - keyed.INIT_PRIOR)]
    assert steps.count(0) == steps.count(1) or name == "slice"


def _nested_model():
    def normal(key):
        return kt.GibbsParameter(key, logtarget=lambda x, v: -0.5 * torch.square(x).sum(-1),
                                 setprior=lambda v: td.Normal(torch.zeros(2), 1.0))

    p4 = kt.GibbsParameter("p4", setpdf=lambda v: td.Normal(0.5 * v["p1"], 1.0))
    return kt.GenericModel([normal("p1"), normal("p2"), normal("p3"), p4])


def test_a_nested_gibbs_sweep_draws_at_counters_of_its_own(recorded):
    """Two sweeps of nested HMC (dual averaging, the hoisted step search),
    the slice sampler (a start from the prior each sweep) and MH with a
    proposal distribution, beside a conditional block: no counter twice,
    every nested draw at step = sweep in the nested region, each block's
    windows apart from the others', the conditional and the prior starts at
    their blocks' sites."""
    sweep = {
        "p1": kt.Nested(kt.HMC(leapstep=0.2, nleaps=3), n_steps=2,
                        tuner=kt.DualAveragingTuner(0.8, 2)),
        "p2": kt.Nested(kt.SliceSampler(max_shrinks=10), n_steps=2, reset_from_prior=True),
        "p3": kt.Nested(kt.MH(proposal_fn=lambda x, s: td.Normal(x, s[:, None])), n_steps=3),
    }
    job = kt.GibbsJob(_nested_model(), sweep, kt.MCRange(n_steps=2), n_chains=8, device="cpu")
    v0 = {k: torch.zeros(2) for k in ("p1", "p2", "p3")} | {"p4": torch.zeros(2)}
    job.run(torch.Generator().manual_seed(2), v0)
    counters = _counters(recorded)
    assert len(counters) == len(set(counters)), counters
    assert {step for step, *_ in counters} == {0, 1}
    nested = {site for _, site, _ in counters if site >= NESTED_SITES}
    assert nested and max(nested) < JOB_SITES
    blocks = {site for _, site, _ in counters if site < NESTED_SITES}
    assert blocks == {1, 3}  # p2's prior starts, p4's conditional
    values = {k: torch.zeros(8, 2) for k in sweep}
    windows = sorted(job._nested_window(k, values) + (sweep[k].n_steps,) for k in sweep)
    for (b0, w0, n0), (b1, _, _) in zip(windows, windows[1:]):
        assert b0 + n0 * w0 <= b1
    for key, spec in sweep.items():
        base, width = job._nested_window(key, values)
        mine = {site for site in nested if base <= site < base + spec.n_steps * width}
        assert mine, key


def test_a_sampler_called_without_a_job_keys_a_stream_from_its_generator():
    """``step`` with a generator and no stream: one run key from the
    generator, the draws at step 0 in MCJob's window; the same generator
    state gives the same step."""
    target = _std()
    sampler = kt.MALA(0.5)
    state = sampler.init(target, torch.zeros(8, 2))
    a, _ = sampler.step(state, target, torch.Generator().manual_seed(3))
    stream = keyed.KeyedStream(keyed.run_key(torch.Generator().manual_seed(3), "cpu"), 8)
    b, _ = sampler.step(state, target, stream=stream)
    torch.testing.assert_close(a.position, b.position, rtol=0, atol=0)
    z = stream.window_site(keyed.PROPOSAL).normal((8, 2))
    torch.testing.assert_close(b.position[b.position != 0], (0.5 ** 0.5 * z)[b.position != 0],
                               rtol=0, atol=0)


DRAW_CALL = re.compile(
    r"torch\.(rand|randn|randint|randperm|rand_like|randn_like|randint_like|normal|bernoulli|"
    r"multinomial|poisson|_standard_gamma|_sample_dirichlet)\(|"
    r"\.(uniform_|normal_|exponential_|geometric_|log_normal_|cauchy_|random_|bernoulli_)\(")


@pytest.mark.parametrize("folder", ["samplers", "jobs"])
def test_no_generator_draw_outside_the_run_key(folder):
    """``samplers/`` and ``jobs/`` call no torch sampling function: their
    draws are keyed, and the one draw from a ``torch.Generator`` is the run
    key (``ops.keyed.run_key``)."""
    path = os.path.join(REPO, "klara_tpu_torch", folder)
    for name in sorted(os.listdir(path)):
        if name.endswith(".py"):
            with open(os.path.join(path, name)) as f:
                for n, line in enumerate(f, 1):
                    assert not DRAW_CALL.search(line), f"{folder}/{name}:{n}: {line.strip()}"
    with open(os.path.join(REPO, "klara_tpu_torch", "ops", "keyed.py")) as f:
        calls = [line for line in f if DRAW_CALL.search(line)]
    assert len(calls) == 1 and "torch.randint(" in calls[0]


def test_the_draw_rule_is_gone():
    from klara_tpu_torch.parallel import mesh

    assert not hasattr(mesh, "draw_chains") and not hasattr(mesh, "no_csv_across_processes")
