"""The port's tracer (``klara_tpu_torch.utils.tracing``), on the CPU.

* span records nest, each naming its parent and its job; none is made
  while recording is off, though counters and job reports still count;
  an active ``torch.profiler`` session turns recording on, as
  ``utils.trace_profile`` does for its block;
* the ring of spans and the deque of reports are bounded;
* a job's report: one per outermost call, its phases by path inside the
  job's ``[t0, t1]``, ``run_phased``'s timings read from the same clock
  reads, the adaptation hooks and host reads counted by site;
* the graph units' timed counters: eager blocks, captures and replays by
  kind, and the steps the eager blocks ran;
* the counts a capture makes are its record, added once a replay (timed
  counters are added at capture alone), whatever the name; the launch
  counts the benchmark reads as module attributes are the tracer's; the
  graph layer imports no kernel module.
"""

import ast
import collections
import inspect

import pytest
import torch

import klara_tpu_torch as kt
from klara_tpu_torch.jobs import graphs
from klara_tpu_torch.models.examples import rats_gibbs_model, synthetic_logistic_regression
from klara_tpu_torch.utils import tracing

BURNIN, POST, CHAINS, DIM = 12, 10, 32, 4


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _hmc(lam, max_nleaps):
    return kt.HMC(leapstep=0.05, nleaps=8, trajectory_length=lam, jitter=0.9,
                  jitter_style="step", max_nleaps=max_nleaps)


def _chees(seed=1):
    """A tiny chees_precond job: (chain, timings, info)."""
    target, _, _ = synthetic_logistic_regression(dim=DIM, n_data=40, device="cpu")
    job = kt.MCJob(target, _hmc(0.5, 32), kt.MCRange(n_steps=BURNIN + POST, burnin=BURNIN),
                   tuner=kt.DualAveragingTuner(0.8, BURNIN), n_chains=CHAINS,
                   monitor=("value",), diagnostics=("accept", "nleaps"), pooled_tuning=True,
                   mass_adaptation=True, mass_period=4, traj_adaptation=True, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    x0 = 0.1 * torch.randn(CHAINS, DIM, generator=gen)
    return job.run_preconditioned(gen, x0, back_transform=False,
                                  stage2_replace=dict(sampler=_hmc(1.0, 16),
                                                      traj_adaptation=False))


def _rats(sweeps=20, burnin=5):
    model, v0 = rats_gibbs_model(device="cpu")
    job = kt.GibbsJob(model, {}, kt.MCRange(n_steps=sweeps, burnin=burnin), n_chains=8,
                      monitor=("alpha_c",), device="cpu")
    return job.run(torch.Generator().manual_seed(0), v0)


# ------------------------------------------------------------------ spans
def test_spans_nest_and_name_their_parents():
    with tracing.recording():
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.timed("c.counter", "c"):
                    pass
            with tracing.span("d"):
                pass
    by = {s.name: s for s in tracing.spans()}
    assert [s.name for s in tracing.spans()] == ["a", "b", "c", "d"]
    assert by["a"].parent is None
    assert by["b"].parent == by["d"].parent == by["a"].id
    assert by["c"].parent == by["b"].id
    for s in by.values():
        assert s.end is not None and s.start <= s.end and s.job is None
    assert by["a"].start <= by["b"].start <= by["c"].start <= by["c"].end <= by["b"].end \
        <= by["d"].start <= by["d"].end <= by["a"].end
    assert tracing.counters()["c.counter"][0] == 1


def test_a_span_carries_its_job():
    with tracing.recording(), tracing.job("outer"), tracing.span("inside"):
        pass
    job_span, inside = tracing.spans()
    (report,) = tracing.reports()
    assert job_span.name == "job" and inside.parent == job_span.id
    assert job_span.job == inside.job == report["job"]


def test_no_records_while_off_but_counters_and_reports_count():
    with tracing.job("j"), tracing.Phases() as phases:
        phases.enter("p", 3)
        with tracing.span("s"), tracing.timed("t.counter"):
            tracing.count("events", 2)
    assert not tracing.active()
    assert tracing.spans() == []
    c = tracing.counters()
    assert c["events"] == (2, 0) and c["t.counter"][0] == 1 and c["t.counter"][1] >= 0
    (report,) = tracing.reports()
    assert report["name"] == "j" and set(report["phases"]) == {"p"}
    assert report["phases"]["p"]["steps"] == 3
    assert report["phases"]["p"]["counters"]["events"] == [2, 0]
    assert report["counters"]["t.counter"][0] == 1


def test_an_active_profiler_turns_recording_on():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert tracing.active()
        with tracing.span("under_profiler"):
            torch.ones(4).sum()
    assert not tracing.active()
    assert [s.name for s in tracing.spans()] == ["under_profiler"]
    # the span also opened a record_function: the trace shows it above the ops
    assert any(e.name == "under_profiler" for e in prof.events())


def test_trace_profile_records_its_block(capsys):
    target, _, _ = synthetic_logistic_regression(dim=DIM, n_data=40, device="cpu")
    job = kt.MCJob(target, kt.MALA(0.05), kt.MCRange(n_steps=4, burnin=2), n_chains=4,
                   device="cpu")
    with kt.utils.trace_profile(label="t"):
        job.run(torch.Generator().manual_seed(0), torch.zeros(DIM))
    names = collections.Counter(s.name for s in tracing.spans())
    # MCJob.run calls the hooks at every step (the tuner stops after burnin)
    assert names["job"] == 1 and names["step"] == names["adapt.tune"] == 4
    assert "[t]" in capsys.readouterr().out


def test_the_ring_and_the_reports_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=3))
    monkeypatch.setattr(tracing, "_reports", collections.deque(maxlen=2))
    with tracing.recording():
        for k in range(5):
            with tracing.span(f"s{k}"):
                pass
    for k in range(4):
        with tracing.job(f"j{k}"):
            pass
    assert [s.name for s in tracing.spans()] == ["s2", "s3", "s4"]
    assert [r["name"] for r in tracing.reports()] == ["j2", "j3"]


def test_an_inner_job_adds_no_report_and_a_failed_job_still_reports():
    with tracing.job("outer"), tracing.job("inner"):
        pass
    with pytest.raises(ValueError):
        with tracing.job("fails"), tracing.Phases() as phases:
            phases.enter("p")
            raise ValueError
    assert [r["name"] for r in tracing.reports()] == ["outer", "fails"]
    assert set(tracing.reports()[1]["phases"]) == {"p"}
    with tracing.job("after"), tracing.Phases() as phases:
        phases.enter("q")
    assert set(tracing.reports()[2]["phases"]) == {"q"}  # no stale path


# ------------------------------------------------------------ job reports
def test_a_preconditioned_job_reports_its_phases():
    _, timings, _ = _chees()
    (report,) = tracing.reports()
    assert report["name"] == "MCJob.run_preconditioned"
    ph = report["phases"]
    assert set(ph) == {"stage1", "stage1.init", "stage1.warmup", "stage1.sampling",
                       "precondition", "stage2", "stage2.init", "stage2.warmup",
                       "stage2.sampling"}
    wall = report["t1"] - report["t0"]
    for p in ph.values():
        assert report["t0"] <= p["t0"] <= p["t1"] <= report["t1"]
        assert p["calls"] == 1 and p["seconds"] >= 0
    assert sum(ph[k]["seconds"] for k in ("stage1", "precondition", "stage2")) <= wall
    for stage in ("stage1", "stage2"):
        inner = sum(ph[f"{stage}.{k}"]["seconds"] for k in ("init", "warmup", "sampling"))
        assert inner <= ph[stage]["seconds"]
        assert ph[stage]["t0"] <= ph[f"{stage}.init"]["t0"]
        assert ph[f"{stage}.sampling"]["t1"] <= ph[stage]["t1"]
    assert [ph[f"stage{s}.warmup"]["steps"] for s in (1, 2)] == [BURNIN, BURNIN]
    assert [ph[f"stage{s}.sampling"]["steps"] for s in (1, 2)] == [1, POST]
    # run_phased's timings are its phases' clock reads
    assert timings["sampling_seconds"] == ph["stage2.sampling"]["seconds"]
    assert timings["warmup_seconds"] == pytest.approx(
        ph["stage1.init"]["seconds"] + ph["stage1.warmup"]["seconds"]
        + ph["stage1.sampling"]["seconds"] + ph["stage2.init"]["seconds"]
        + ph["stage2.warmup"]["seconds"], abs=1e-9)
    c = report["counters"]
    # every warmup step runs the hooks; each eager step reads its leap counts
    assert c["adapt.tune"][0] == c["adapt.mass"][0] == 2 * BURNIN
    assert c["adapt.chees"][0] == BURNIN
    # ChEES copies five host scalars to the device in each of its active steps
    active = BURNIN - int(BURNIN * kt.MCJob.traj_start_frac)
    assert c["host_read.chees_scalars"][0] == 5 * active
    assert c["host_read.chees_scalars"][1] <= c["adapt.chees"][1]
    assert "host_read.chees_scalars" not in ph["stage2.warmup"]["counters"]
    assert c["host_read.leapfrog_bounds"][0] == 2 * BURNIN
    assert ph["stage1.warmup"]["counters"]["host_read.leapfrog_bounds"][0] == BURNIN
    assert "host_read.leapfrog_bounds" not in ph["stage2.sampling"]["counters"]
    # sampling reads each block's bounds once; the search reads each iteration
    assert ph["stage2.sampling"]["counters"]["host_read.block_bounds"][0] == \
        -(-POST // graphs.STEPS_PER_BLOCK)
    assert ph["stage1.init"]["counters"]["host_read.step_search"][0] >= 1
    assert "host_read.step_search" not in ph["stage2.init"]["counters"]
    assert c["host_read.checkin"][0] == 2
    # K1's and K2's wrappers time every call, on the CPU their plain versions
    warm = ph["stage1.warmup"]["counters"]
    assert warm["k1.host_ns"][0] >= BURNIN and warm["k2.host_ns"][0] >= 2 * BURNIN
    assert all(n >= 0 and ns >= 0 for n, ns in c.values())


def test_an_untraced_job_leaves_no_spans_and_one_report_each():
    for seed in (1, 2):
        _chees(seed)
    assert tracing.spans() == []
    assert [r["name"] for r in tracing.reports()] == ["MCJob.run_preconditioned"] * 2
    a, b = tracing.reports()
    assert a["t1"] <= b["t0"] and a["job"] != b["job"]


def test_a_recorded_job_has_its_spans_inside_its_window():
    with tracing.recording():
        _chees()
    (report,) = tracing.reports()
    spans = tracing.spans()
    names = collections.Counter(s.name for s in spans)
    assert names["job"] == 1 and names["step"] == 2 * BURNIN
    assert names["adapt.tune"] == 2 * BURNIN and names["warmup"] == 2
    assert names["block"] == 1 + -(-POST // graphs.STEPS_PER_BLOCK)
    for s in spans:
        assert s.job == report["job"]
        assert report["t0"] <= s.start / 1e9 and s.end / 1e9 <= report["t1"] + 1e-9
    ids = {s.id: s for s in spans}
    for s in spans:
        if s.name == "step":
            assert ids[s.parent].name == "warmup"
        if s.name.startswith("adapt."):
            assert ids[s.parent].name == "step"
        if s.name == "host_read.chees_scalars":
            assert ids[s.parent].name == "adapt.chees"
    assert names["host_read.chees_scalars"] == 5 * (BURNIN - int(BURNIN * 0.1))


def test_a_gibbs_job_reports_setup_and_sweeps():
    _rats(sweeps=20)
    (report,) = tracing.reports()
    assert report["name"] == "GibbsJob.run"
    ph = report["phases"]
    assert list(ph) == ["setup", "sweeps"]
    assert ph["sweeps"]["steps"] == 20 and ph["setup"]["steps"] is None
    assert ph["setup"]["t1"] == ph["sweeps"]["t0"]  # one clock read between them
    assert report["t0"] <= ph["setup"]["t0"] and ph["sweeps"]["t1"] <= report["t1"]


def test_mcjob_run_reports_init_and_steps():
    target, _, _ = synthetic_logistic_regression(dim=DIM, n_data=40, device="cpu")
    job = kt.MCJob(target, kt.MALA(0.05), kt.MCRange(n_steps=6, burnin=2), n_chains=4,
                   device="cpu")
    chain = job.run(torch.Generator().manual_seed(0), torch.zeros(DIM))
    job.resume(torch.Generator().manual_seed(1), chain)
    run, resume = tracing.reports()
    assert (run["name"], resume["name"]) == ("MCJob.run", "MCJob.resume")
    assert list(run["phases"]) == ["init", "steps"] and list(resume["phases"]) == ["steps"]
    assert run["phases"]["steps"]["steps"] == resume["phases"]["steps"]["steps"] == 6
    assert run["counters"]["adapt.tune"][0] == 6


# ------------------------------------------------------------ graph units
class _FakeGraph:
    def __init__(self):
        self.body = None

    def replay(self):
        tracing.counted(self.body)


def test_graph_units_count_eager_blocks_captures_and_replays(monkeypatch):
    units = graphs.Units("cpu")
    units.capture = True

    def record(graph, body):
        graph.body = body

    monkeypatch.setattr(units, "_warm", lambda body: body())
    monkeypatch.setattr(units, "_new_graph", _FakeGraph)
    monkeypatch.setattr(units, "_record", record)
    monkeypatch.setattr(units, "_launch", lambda graph: graph.replay())
    with tracing.recording():
        for key in ["head"] * 4 + [("prepass", 20)] * 3 + [100] * 2:
            units.run(key, lambda: None)
    c = tracing.counters()
    assert c["graphs.eager_blocks"][0] == 3 and c["graphs.captures"][0] == 3
    assert c["graphs.replays.head"][0] == 3 and c["graphs.replays.prepass"][0] == 2
    assert c["graphs.replays.sweeps"][0] == 1
    names = collections.Counter(s.name for s in tracing.spans())
    assert names == {"eager_block": 3, "capture": 3, "replay.head": 3, "replay.prepass": 2,
                     "replay.sweeps": 1}
    assert "graphs.eager_steps" not in c     # no unit said it runs whole steps


def test_graph_units_say_which_block_ran_eagerly(monkeypatch):
    units = graphs.Units("cpu")
    assert units.run(100, lambda: None) is False             # the CPU: no graphs
    units.capture = True
    monkeypatch.setattr(units, "_warm", lambda body: body())
    monkeypatch.setattr(units, "_capture", lambda body: (_FakeGraph(), ()))
    monkeypatch.setattr(units, "_launch", lambda graph: None)
    ran = [units.run(key, lambda: None) for key in [100] * 3 + [40] * 2 + [("block", 20)] * 2]
    # the first block of each key runs eagerly, the second is captured
    assert ran == [True, False, False, True, False, True, False]
    assert tracing.counters()["graphs.eager_blocks"][0] == 3


def test_a_capture_records_its_counts_and_each_replay_adds_them_once(monkeypatch):
    """A count under a name no module declares is the capture's record, not
    added, and is added once a replay; a timed counter in the same body is
    added when the body runs (eager and at capture), never at a replay."""
    units = graphs.Units("cpu")
    units.capture = True

    def body():
        tracing.count("made.up.events", 3)
        with tracing.timed("made.up.timed"):
            pass

    def record(graph, body):
        graph.body = body
        body()  # a capture calls the body, which counts

    monkeypatch.setattr(units, "_warm", lambda body: body())
    monkeypatch.setattr(units, "_new_graph", _FakeGraph)
    monkeypatch.setattr(units, "_record", record)
    monkeypatch.setattr(units, "_launch", lambda graph: None)  # a replay runs no Python
    units.run("block", body)                                   # eager
    assert tracing.counters()["made.up.events"][0] == 3
    units.run("block", body)                                   # captured, then replayed
    assert units._graphs["block"][1] == (("made.up.events", 3),)
    c = tracing.counters()
    assert c["made.up.events"][0] == 3 + 3 and c["made.up.timed"][0] == 2
    for _ in range(4):
        units.run("block", body)
    c = tracing.counters()
    assert c["made.up.events"][0] == 3 + 5 * 3 and c["made.up.timed"][0] == 2


def test_the_benchmarks_launch_reads_are_the_tracers_counts():
    """``ops.logreg.KERNEL_LAUNCHES`` and ``ops.keyed.KERNEL_LAUNCHES``
    (read by ``portbench/counters.py``) are the tracer's counts, and a
    reset clears them."""
    from klara_tpu_torch.ops import keyed, logreg

    assert (logreg.KERNEL_LAUNCHES, keyed.KERNEL_LAUNCHES) == (0, 0)
    tracing.count("ops.logreg.KERNEL_LAUNCHES", 3)
    tracing.count("ops.keyed.KERNEL_LAUNCHES", 5)
    assert (logreg.KERNEL_LAUNCHES, keyed.KERNEL_LAUNCHES) == (3, 5)
    tracing.reset()
    assert (logreg.KERNEL_LAUNCHES, keyed.KERNEL_LAUNCHES) == (0, 0)
    with pytest.raises(AttributeError):
        logreg.LAUNCHES


def test_the_graph_layer_imports_no_kernel_module():
    """``jobs.graphs`` counts by the tracer's rule, so it imports no module
    of ``ops`` and not ``core.target``."""
    tree = ast.parse(inspect.getsource(graphs))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
              for a in n.names]
    assert names and not [n for n in names if n.startswith(("klara_tpu_torch.ops",
                                                             "klara_tpu_torch.core.target"))]


def test_a_gibbs_job_on_graph_units_counts_its_eager_sweeps(monkeypatch):
    real = graphs.Units.run

    def run(self, key, body):
        self.capture = True
        monkeypatch.setattr(self, "_warm", lambda body: body())
        monkeypatch.setattr(self, "_capture", lambda body: (_FakeGraph(), body))
        monkeypatch.setattr(self, "_launch", lambda graph: None)
        monkeypatch.setattr(tracing, "recount", lambda body: body())
        return real(self, key, body)

    monkeypatch.setattr(graphs.Units, "run", run)
    monkeypatch.setattr(graphs, "SWEEPS_PER_BLOCK", 6)
    _rats(sweeps=20)
    sweeps = tracing.reports()[0]["phases"]["sweeps"]["counters"]
    # blocks of 6, 6, 6 and 2 sweeps: the first of each size runs eagerly
    assert sweeps["graphs.eager_steps"] == [6 + 2, 0]
    assert sweeps["graphs.eager_blocks"][0] == 2 and sweeps["graphs.replays.sweeps"][0] == 2


@pytest.mark.parametrize("key,kind", [("head", "head"), ("masked leap", "masked leap"),
                                      (("block", 20), "block"), (("prepass", 7), "prepass"),
                                      (100, "sweeps")])
def test_kind_of_a_unit_key(key, kind):
    assert graphs.kind_of(key) == kind
