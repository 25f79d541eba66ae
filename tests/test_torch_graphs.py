"""The captured sampling loops (``klara_tpu_torch.jobs.graphs``), on the CPU.

On the card a block of steps or sweeps is captured once into a CUDA graph
and replayed; on the CPU the same blocks run eagerly, which is what these
tests hold to the per-step loop:

* (a) K2's plain version at ``at(step=counter, step_add=k)`` draws, bit for
  bit, what it draws at the int step base + k;
* (b) the blocked loop is bit for bit the per-step loop (traces,
  diagnostics, final state) for the conjugate rats ``GibbsJob``, ``MCJob``
  with static NUTS and with HMC under dynamic leap counts and shared
  jitter (pooled: one leap count a step; per-chain ε: the masked form), each
  with thinning 2 and a tail block shorter than the rest;
* (c) a block reads nothing back: ``Tensor.item``, ``tolist``, ``__bool__``,
  ``__int__`` and ``__float__`` raise inside every block (the plain K2,
  which stands in for the kernel here, is exempt);
* (d) the blocked rats ``GibbsJob`` lands on the JAX package's posterior
  means within 4 combined Monte Carlo standard errors;
* (e) the counts a capture makes are its record, not added, and every
  replay adds the record once, so the launch counts equal the eager loop's;
  a failed capture raises;
* (f) HMC's warmup, its transitions replayed as units and the adaptation
  hooks eager between steps, is bit for bit the eager warmup (pooled
  tuning, ChEES and mass on; per-chain ε: the masked form), and the hooks
  get fresh tensors: what an override keeps of what it is handed and
  returns is the eager run's after the run, and shares storage as there.
"""

import numpy as np
import jax
import pytest
import torch

import klara_tpu as jkt
from klara_tpu.models import examples as jex

import klara_tpu_torch as kt
from klara_tpu_torch.jobs import graphs
from klara_tpu_torch.models import examples as tex
from klara_tpu_torch.ops import keyed
from klara_tpu_torch.utils import tracing

WARMUP_KINDS = ("warmup head", "warmup leap", "warmup masked leap", "warmup tail")
RATS = ("alpha_c", "beta_c", "sigma2_c", "sigma2_a", "sigma2_b")
C, D, N = 32, 5, 50
BURNIN, POST, THIN = 10, 31, 2   # 31 sampling steps: blocks of 4 leave a tail of 3
SWEEPS, SWEEP_BURNIN = 40, 5     # blocks of 6 sweeps leave a tail of 4


def _bits(t):
    """A tensor's raw bits (NaN equal to NaN of the same bits)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    t = t.contiguous()
    return t if t.dtype == torch.bool else t.view(ints[t.element_size()])


def _same(a, b):
    ta, tb = graphs._tensors(a, []), graphs._tensors(b, [])
    return len(ta) == len(tb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(ta, tb))


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(graphs, "STEPS_PER_BLOCK", 4)
    monkeypatch.setattr(graphs, "SWEEPS_PER_BLOCK", 6)
    keys = []
    run = graphs.Units.run

    def spy(self, key, body):
        keys.append(key)
        return run(self, key, body)

    monkeypatch.setattr(graphs.Units, "run", spy)
    return keys


def _eager(monkeypatch):
    """The per-step loops: no sampler or sweep goes to the blocks."""
    monkeypatch.setattr(graphs, "sampling_kind", lambda job: None)
    monkeypatch.setattr(graphs, "sweeps_capturable", lambda job: False)


# ------------------------------------------------------------------ (a)
@pytest.mark.parametrize("base,k", [(0, 0), (7, 3), (2**32 - 2, 5)])
def test_a_counter_step_with_an_offset_draws_as_the_int_step(base, k):
    stream = keyed.KeyedStream(keyed.run_key(torch.Generator().manual_seed(4), "cpu"), 6,
                               offset=10, site=3)
    counter = torch.tensor(base, dtype=torch.int64)
    at = stream.at(step=counter, step_add=k)
    assert at.step is counter and at.step_add == k
    want = stream.at(step=base + k)
    for mode, params in ((keyed.NORMAL, ()), (keyed.GAMMA, (0.7,)), (keyed.BINOMIAL, (30.0, 0.4))):
        got = keyed.draws(at, mode, (6, 3), torch.float32, *params)[0]
        ref = keyed.draws(want, mode, (6, 3), torch.float32, *params)[0]
        assert torch.equal(_bits(got), _bits(ref)), mode
    # the kernel reads the counter by pointer and adds step_add; a new step drops it
    *_, fields = keyed.launch_args(at, keyed.UNIFORM, (6, 2), torch.float32)
    f = dict(zip(keyed.ARG_FIELDS[2:], fields))
    assert f["step"] == counter.data_ptr() and f["step_add"] == k
    assert at.at(step=counter).step_add == 0 and at.at(site=4).step_add == k


# ------------------------------------------------------------------ (b)
def _rats(chains=64, sweeps=SWEEPS, burnin=SWEEP_BURNIN, thinning=THIN, seed=0):
    model, v0 = tex.rats_gibbs_model(device="cpu")
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=sweeps, burnin=burnin, thinning=thinning),
                      n_chains=chains, monitor=RATS)
    return job.run(torch.Generator().manual_seed(seed), v0)


def _jitter_hmc():
    return kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=0.5, jitter=0.9,
                  jitter_style="step", max_nleaps=64)


SAMPLERS = {
    "nuts_static": (lambda: kt.NUTS(max_doublings=3), True, "na"),
    "hmc_shared_jitter_pooled": (_jitter_hmc, True, "nleaps"),
    "hmc_shared_jitter_per_chain_step": (_jitter_hmc, False, "nleaps"),
}


def _mcjob(name, seed=3, **kw):
    sampler, pooled, diag = SAMPLERS[name]
    target, _, _ = tex.synthetic_logistic_regression(dim=D, n_data=N, device="cpu")
    job = kt.MCJob(target, sampler(), kt.MCRange(n_steps=BURNIN + POST, burnin=BURNIN,
                                                 thinning=THIN),
                   tuner=kt.DualAveragingTuner(0.8, BURNIN), n_chains=C,
                   monitor=("value", "logtarget"), diagnostics=("accept", diag),
                   pooled_tuning=pooled, mass_adaptation=True, mass_period=5, device="cpu",
                   **kw)
    gen = torch.Generator().manual_seed(seed)
    return job.run_phased(gen, 0.1 * torch.randn(C, D, generator=gen))[0]


def test_blocked_rats_sweeps_are_the_per_sweep_loop(small_blocks, monkeypatch):
    blocked = _rats()
    assert small_blocks == [6] * (SWEEPS // 6) + [SWEEPS % 6]
    _eager(monkeypatch)
    eager = _rats()
    assert blocked.samples["alpha_c"].shape == ((SWEEPS - SWEEP_BURNIN + 1) // 2, 64)
    for key in RATS:
        assert torch.equal(_bits(blocked.samples[key]), _bits(eager.samples[key])), key
    assert blocked.final_values.keys() == eager.final_values.keys()
    assert _same(tuple(blocked.final_values.values()), tuple(eager.final_values.values()))


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_blocked_sampling_is_the_per_step_loop(name, small_blocks, monkeypatch):
    blocked = _mcjob(name)
    if name == "nuts_static":
        assert small_blocks == [("block", 4)] * (POST // 4) + [("block", POST % 4)]
    else:
        prepass = [k for k in small_blocks if k[0] == "prepass"]
        assert prepass == [("prepass", 4)] * (POST // 4) + [("prepass", POST % 4)]
        # a step's leaps, unmasked and masked, from the replays between its start and end
        steps = []
        for key in small_blocks:
            if key == "head":
                steps.append([0, 0])
            elif key in ("leap", "masked leap"):
                steps[-1][key == "masked leap"] += 1
        assert small_blocks.count("tail") == len(steps) == POST
        # at most six graphs however many leap counts the run meets; the
        # warmup's transitions have units of their own
        assert set(small_blocks) <= set(prepass) | {"head", "leap", "masked leap", "tail"} \
            | set(WARMUP_KINDS)
        counts = blocked.diagnostics["nleaps"]
        assert counts.amax(1).tolist() == [sum(s) for s in steps[::THIN]]
        assert len({sum(s) for s in steps}) > 1  # the jitter moves the leap count
        if "per_chain" in name:  # the chains' counts differ: the masked leapfrog
            assert any(masked for _, masked in steps)
            assert counts.amin(1).tolist() == [s[0] for s in steps[::THIN]]
    _eager(monkeypatch)
    eager = _mcjob(name)
    for group in ("samples", "diagnostics"):
        a, b = getattr(blocked, group), getattr(eager, group)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape[0] == (POST + 1) // 2
            assert torch.equal(_bits(a[k]), _bits(b[k])), (group, k)
    assert _same(blocked.final_state, eager.final_state)


@pytest.mark.parametrize("name", ["nuts_static", "hmc_shared_jitter_pooled"])
def test_blocked_sampling_without_traces_ends_where_the_per_step_loop_does(
        name, small_blocks, monkeypatch):
    blocked = _mcjob(name, destination="none")
    assert small_blocks and not blocked.samples and not blocked.diagnostics
    _eager(monkeypatch)
    assert _same(blocked.final_state, _mcjob(name, destination="none").final_state)


class _Mesh:
    """A mesh's shape alone: what ``MCJob`` and ``sampling_kind`` read."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]

    def get_group(self, i):
        return None

    def get_local_rank(self, i):
        return 0


@pytest.mark.parametrize("names,sizes,kind", [
    (("chains",), (2,), "leaps"),
    (("chains", "param"), (1, 1), "leaps"),
    (("chains", "param"), (1, 2), None),  # a param-sharded target runs collectives
    (("chains", "param"), (2, 2), None),
])
def test_a_target_sharded_over_a_param_axis_samples_eagerly(names, sizes, kind):
    target, _, _ = tex.synthetic_logistic_regression(dim=D, n_data=N, device="cpu")
    job = kt.MCJob(target, _jitter_hmc(), kt.MCRange(n_steps=4, burnin=2), n_chains=C,
                   mesh=_Mesh(names, sizes), device="cpu")
    assert graphs.sampling_kind(job) == kind
    assert graphs.sampling_kind(
        kt.MCJob(target, _jitter_hmc(), kt.MCRange(n_steps=4, burnin=2), n_chains=C,
                 device="cpu")) == "leaps"


# ------------------------------------------------------------------ (c)
_READS = ("item", "tolist", "__bool__", "__int__", "__float__")


@pytest.fixture
def no_host_reads(monkeypatch):
    """Inside every block, a read of a tensor's value raises; the plain K2,
    the kernel's stand-in on the CPU, reads its key and counter freely."""
    originals = {name: getattr(torch.Tensor, name) for name in _READS}
    inside = []

    def forbidden(name):
        def read(self, *args, **kw):
            if inside and inside[-1]:
                raise AssertionError(f"Tensor.{name} inside a captured block")
            return originals[name](self, *args, **kw)
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, forbidden(name))
    run, plain = graphs.Units.run, keyed.draws_reference
    blocks = []

    def guarded(self, key, body):
        def checked():
            inside.append(True)
            try:
                body()
            finally:
                inside.pop()
        blocks.append(key)
        return run(self, key, checked)

    def free(*args, **kw):
        inside.append(False)
        try:
            return plain(*args, **kw)
        finally:
            inside.pop()

    monkeypatch.setattr(graphs.Units, "run", guarded)
    monkeypatch.setattr(keyed, "draws_reference", free)
    monkeypatch.setattr(graphs, "STEPS_PER_BLOCK", 4)
    monkeypatch.setattr(graphs, "SWEEPS_PER_BLOCK", 6)
    return blocks, inside


@pytest.mark.parametrize("name", ["rats"] + sorted(SAMPLERS))
def test_a_block_reads_nothing_back(name, no_host_reads):
    blocks, inside = no_host_reads
    out = _rats(sweeps=12) if name == "rats" else _mcjob(name)
    assert blocks
    if name.startswith("hmc"):  # the warmup's units are guarded too
        assert {"warmup head", "warmup leap", "warmup tail"} <= set(blocks)
        # one host read a warmup step, the leap counts', as in the eager loop
        warmup = tracing.reports()[-1]["phases"]["warmup"]
        assert warmup["counters"]["host_read.leapfrog_bounds"][0] == warmup["steps"] == BURNIN
    inside.append(True)  # the guard itself: a read inside a block raises
    with pytest.raises(AssertionError, match="inside a captured block"):
        bool(torch.ones(()))
    inside.pop()
    tensors = graphs._tensors(tuple(out.samples.values()), [])
    assert all(bool(torch.isfinite(t.float()).all()) for t in tensors)


# ------------------------------------------------------------------ (d)
def test_blocked_rats_land_on_the_jax_posterior(monkeypatch):
    """64 chains x 300 sweeps (100 burnin) in blocks of 32 (a tail of 12)
    in both packages: every monitored mean within 4 combined MCSE."""
    monkeypatch.setattr(graphs, "SWEEPS_PER_BLOCK", 32)
    chains, sweeps, burnin = 64, 300, 100
    model, v0 = jex.rats_gibbs_model()
    jchains = jkt.GibbsJob(model, {}, jkt.MCRange(n_steps=sweeps, burnin=burnin),
                           n_chains=chains, monitor=RATS).run(jax.random.key(1), v0)
    tchains = _rats(chains, sweeps, burnin, 1, seed=1)
    for key in RATS:
        means, ses = [], []
        for x in (torch.from_numpy(np.array(jchains.samples[key])), tchains.samples[key]):
            means.append(float(kt.stats.mean(x)))
            ses.append(float(np.sqrt(kt.stats.mcvar(x).numpy().mean(0) / x.shape[1])))
        assert abs(means[0] - means[1]) < 4.0 * np.hypot(*ses), (key, means, ses)


# ------------------------------------------------------------------ (e)
K1, K2, NORMAL = ("ops.logreg.KERNEL_LAUNCHES", "ops.keyed.KERNEL_LAUNCHES",
                  "ops.keyed.LAUNCHES_BY_MODE.normal")


class _FakeGraph:
    """A replay runs the captured work without the wrappers counting."""

    def __init__(self):
        self.body = None

    def replay(self):
        tracing.counted(self.body)


def _units(monkeypatch, record):
    units = graphs.Units("cpu")
    units.capture = True
    monkeypatch.setattr(units, "_warm", lambda body: body())
    monkeypatch.setattr(units, "_new_graph", _FakeGraph)
    monkeypatch.setattr(units, "_record", record)
    monkeypatch.setattr(units, "_launch", lambda graph: graph.replay())
    return units


def _launching_body(ran):
    def body():  # what a block's wrappers count: one K1 launch, two K2 normals
        tracing.count(K1)
        tracing.count(K2, 2)
        tracing.count(NORMAL, 2)
        ran.append(1)
    return body


@pytest.fixture
def counts():
    """The tracer's count of a name made since the test began."""
    before = tracing.counters()
    return lambda name: (tracing.counters().get(name, (0, 0))[0]
                         - before.get(name, (0, 0))[0])


def test_replays_add_the_launches_a_capture_recorded(monkeypatch, counts):
    ran = []
    body = _launching_body(ran)
    rec = tracing.counted(body)
    assert dict(rec) == {K1: 1, K2: 2, NORMAL: 2} and len(ran) == 1
    assert (counts(K1), counts(K2), counts(NORMAL)) == (0, 0, 0)

    def record(graph, body):
        graph.body = body
        body()  # a capture calls the wrappers, which count

    units = _units(monkeypatch, record)
    for _ in range(5):  # eager, captured and replayed, then three replays
        units.run("block", body)
    assert (counts(K1), counts(K2)) == (5, 10)
    assert counts(NORMAL) == 10
    assert (counts("graphs.captures"), counts("graphs.replays.block")) == (1, 4)
    assert units._graphs["block"][1] == rec   # the record each replay added


def test_a_failed_capture_raises_and_runs_nothing_eagerly(monkeypatch, counts):
    ran = []
    body = _launching_body(ran)

    def record(graph, body):
        body()
        raise RuntimeError("capture failed")

    units = _units(monkeypatch, record)
    units.run("block", body)
    with pytest.raises(RuntimeError, match="capture failed"):
        units.run("block", body)
    assert (counts(K1), counts(K2), len(ran)) == (1, 2, 2)
    assert counts("graphs.replays.block") == 0 and units._graphs == {}
    tracing.count(K1)   # counts after the failed capture are added again
    assert counts(K1) == 2


# ------------------------------------------------------------------ (f)
WARM, WARM_POST = 16, 9  # ChEES from step 1, mass at steps 4, 9 and 14


def _stage2_hmc():
    return kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=1.0, jitter=0.9,
                  jitter_style="step", max_nleaps=16)


def _adapting_job(name, cls=kt.MCJob):
    sampler, pooled, _ = SAMPLERS[name]
    target, _, _ = tex.synthetic_logistic_regression(dim=D, n_data=N, device="cpu")
    return cls(target, sampler(), kt.MCRange(n_steps=WARM + WARM_POST, burnin=WARM),
               tuner=kt.DualAveragingTuner(0.8, WARM), n_chains=C, monitor=("value",),
               diagnostics=("accept", "nleaps"), pooled_tuning=pooled, mass_adaptation=True,
               mass_period=5, traj_adaptation=True, device="cpu")


def _start(seed):
    gen = torch.Generator().manual_seed(seed)
    return gen, 0.1 * torch.randn(C, D, generator=gen)


WARMUPS = ["hmc_shared_jitter_pooled", "hmc_shared_jitter_per_chain_step"]


@pytest.mark.parametrize("name", WARMUPS)
def test_graph_warmup_is_the_eager_warmup(name, small_blocks, monkeypatch):
    def run():
        chain, _, info = _adapting_job(name).run_preconditioned(
            *_start(7), back_transform=False,
            stage2_replace=dict(sampler=_stage2_hmc(), traj_adaptation=False))
        return chain, info

    graph, ginfo = run()
    # both stages' warmups replay their transitions; per-chain ε masks leaps
    assert small_blocks.count("warmup head") == small_blocks.count("warmup tail") == 2 * WARM
    assert ("warmup masked leap" in small_blocks) == ("per_chain" in name)
    _eager(monkeypatch)
    eager, einfo = run()
    for group in ("samples", "diagnostics"):
        a, b = getattr(graph, group), getattr(eager, group)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(_bits(a[k]), _bits(b[k])), (group, k)
    assert _same(graph.final_state, eager.final_state)
    assert _same(ginfo["stage1_state"], einfo["stage1_state"])
    assert torch.equal(_bits(ginfo["chol"]), _bits(einfo["chol"]))


class _Keeping(kt.MCJob):
    """An ``MCJob`` whose hooks keep references, not copies, to everything
    they are handed and return, as the benchmark's recording job does."""

    kept = None

    def adapt(self, prev_pos, states, infos, i, frac_shared=1.0):
        new = super().adapt(prev_pos, states, infos, i, frac_shared)
        _Keeping.kept.append((prev_pos, states, infos, frac_shared, new))
        return new


def _storage_groups(steps):
    """The kept tensors that share storage, as sets of (step, leaf)."""
    by = {}
    for s, entry in enumerate(steps):
        for k, t in enumerate(graphs._tensors(entry, [])):
            by.setdefault(t.untyped_storage().data_ptr(), set()).add((s, k))
    return sorted(sorted(g) for g in by.values())


@pytest.mark.parametrize("name", WARMUPS)
def test_the_hooks_get_fresh_tensors_and_what_they_keep_stays(name, monkeypatch):
    def run():
        _Keeping.kept = []
        _adapting_job(name, _Keeping).run_phased(*_start(11))
        return _Keeping.kept

    graph = run()
    _eager(monkeypatch)
    eager = run()
    assert len(graph) == len(eager) == WARM
    for s, (a, b) in enumerate(zip(graph, eager)):
        assert _same(a, b), s  # each step's, read after the whole run
    assert _storage_groups(graph) == _storage_groups(eager)
    # no two steps' infos share storage: nothing handed out is written again
    infos = [{t.untyped_storage().data_ptr() for t in graphs._tensors(e[2], [])}
             for e in graph]
    assert all(not (infos[i] & infos[j]) for i in range(WARM) for j in range(i))
