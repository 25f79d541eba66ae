"""The readers of the program's own trace (``portbench/program.py`` and the
metrics that read the job reports and spans), on synthetic records: a
window job's report found by time, the warm, sync-mode and profiled jobs'
reports matching no window job; each reader's number; the idle attribution
by innermost span; nothing reported, and nothing raised, where the program
has no tracer."""

from __future__ import annotations

import sys

import pytest

from klara_tpu_torch.utils import tracing
from portbench import harness, program
from portbench.trace import Summary

NEW = ("init_s", "adapt_ms_per_step", "warmup_host_reads_per_step", "replays_per_step",
       "capture_s", "gibbs_us_per_sweep", "adapt_idle_pct", "k1_host_us_per_call",
       "k2_host_us_per_call")


def _rec(t0, t1, split=None):
    """A job record as the job kinds write it: its spans on the host clock."""
    if split is None:
        return {"spans": {"sampling": (t0, t1)}}
    return {"spans": {"warmup": (t0, split), "sampling": (split, t1)}}


def _phase(t0, t1, steps=None, **counters):
    return {"t0": t0, "t1": t1, "seconds": t1 - t0, "steps": steps, "calls": 1,
            "counters": {k.replace("__", "."): v for k, v in counters.items()}}


def _chees_report(job, t0):
    """A two-stage job's report from ``t0``: 1 s init, 2 s warmup (100 steps)
    and 1 s sampling (50 steps) a stage."""
    ph = {}
    for s, base in ((1, t0 + 0.1), (2, t0 + 5)):
        ph[f"stage{s}.init"] = _phase(base, base + 1, None, host_read__step_search=[4, 10**6],
                                      k1__host_ns=[5, 10**5])
        ph[f"stage{s}.warmup"] = _phase(
            base + 1, base + 3, 100, adapt__tune=[100, 2 * 10**6], adapt__mass=[100, 10**6],
            adapt__chees=[100, 4 * 10**6], host_read__chees_scalars=[250, 3 * 10**6],
            host_read__leapfrog_bounds=[100, 5 * 10**6], host_read__sync=[1, 10],
            k1__host_ns=[995, 3 * 10**7], k2__host_ns=[200, 4 * 10**6])
        ph[f"stage{s}.sampling"] = _phase(
            base + 3, base + 4, 50, graphs__replays__leap=[300, 10**6],
            graphs__replays__head=[50, 10**5], host_read__block_bounds=[3, 100],
            k1__host_ns=[7, 10**9], k2__host_ns=[3, 10**9])
    return {"name": "MCJob.run_preconditioned", "job": job, "t0": t0, "t1": t0 + 9.5,
            "phases": ph, "counters": {"graphs.eager_blocks": [4, 3 * 10**8],
                                       "graphs.captures": [4, 10**8]}}


def _gibbs_report(job, t0):
    return {"name": "GibbsJob.run", "job": job, "t0": t0, "t1": t0 + 5,
            "phases": {"setup": _phase(t0, t0 + 0.5),
                       "sweeps": _phase(t0 + 0.5, t0 + 4.5, 20000,
                                        graphs__eager_blocks=[1, 3 * 10**8],
                                        graphs__captures=[1, 2 * 10**8],
                                        graphs__eager_steps=[100, 0])},
            "counters": {"graphs.eager_blocks": [1, 3 * 10**8], "graphs.captures": [1, 2 * 10**8],
                         "graphs.eager_steps": [100, 0]}}


@pytest.fixture
def fresh(monkeypatch):
    tracing.reset()
    yield
    tracing.reset()


def _window(make, fresh):
    """A run of three window jobs between a warm job, and a sync-mode and a
    profiled job after them, with the program's reports of all five."""
    tracing._reports.extend([make(0, 0.0), make(1, 20.0), make(2, 30.0), make(3, 40.0),
                             make(4, 50.0), make(5, 60.0)])
    jobs = [_rec(19.9, 29.8, 25.0), _rec(29.9, 39.8, 35.0), _rec(39.9, 49.8, 45.0)]
    synced = (_rec(49.9, 59.8, 55.0), [])
    traced = _rec(59.9, 69.8, 65.0)
    return harness.Run(10.0, jobs, None, traced, synced)


def test_each_window_job_matches_its_report_and_no_other(fresh):
    run = _window(_chees_report, fresh)
    assert [r["job"] for r in program.job_reports(run, "t")] == [1, 2, 3]
    reports = tracing.reports()
    warm, synced, profiled = reports[0], reports[4], reports[5]
    for rec in run.jobs:
        assert warm not in program.match(rec, reports)
        assert synced not in program.match(rec, reports)
        assert profiled not in program.match(rec, reports)
    assert program.match(run.synced[0], reports) == [synced]
    assert program.traced_report(run, "t")[0] is profiled


def test_a_job_without_exactly_one_report_reports_nothing(fresh, capsys):
    run = _window(_chees_report, fresh)
    tracing._reports.append(_chees_report(9, 20.05))   # a second report inside job 0
    assert program.job_reports(run, "init_s") is None
    assert "window job 0 has 2 program reports" in capsys.readouterr().err
    tracing.reset()
    assert program.job_reports(run, "init_s") is None  # none at all


def test_the_readers_of_a_chees_window(fresh):
    run = _window(_chees_report, fresh)

    def read(name):
        return harness.reader(name)(run)

    assert read("init_s") == pytest.approx(2.0)                 # two 1 s inits a job
    # the hooks' 7 ms a stage, less ChEES's 3 ms of scalar copies inside them
    assert read("adapt_ms_per_step") == pytest.approx(4e6 * 2 / 200 / 1e6)
    # init: 4 reads; warmup: 351 reads a stage; over 200 warmup steps
    assert read("warmup_host_reads_per_step") == pytest.approx((4 + 351) * 2 / 200)
    # init and warmup alone: 1000 K1 calls in 30.1 ms, 200 K2 calls in 4 ms a stage
    assert read("k1_host_us_per_call") == pytest.approx(30.1e6 / 1000 / 1e3)
    assert read("k2_host_us_per_call") == pytest.approx(4e6 / 200 / 1e3)
    assert read("replays_per_step") == pytest.approx(350 / 50)  # stage 2's sampling
    assert read("capture_s") == pytest.approx(0.4)
    assert read("gibbs_us_per_sweep") is None                 # no sweeps phase


def test_the_readers_of_a_gibbs_window(fresh):
    run = _window(_gibbs_report, fresh)
    # the 4 s phase less 0.5 s of eager block and capture, over the 19900 replayed sweeps
    assert harness.reader("gibbs_us_per_sweep")(run) == pytest.approx(1e6 * 3.5 / 19900)
    assert harness.reader("capture_s")(run) == pytest.approx(0.5)
    assert harness.reader("replays_per_step")(run) is None    # no sampling phase
    assert harness.reader("k1_host_us_per_call")(run) is None  # no K1 call


@pytest.mark.parametrize("name", NEW)
def test_without_the_tracer_nothing_is_reported_and_nothing_raised(name, monkeypatch, capsys):
    """The parent of this change has no ``utils.tracing``: every reader
    returns None and says why."""
    import klara_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "klara_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(klara_tpu_torch.utils, "tracing")
    trace = Summary([("k", 0.5, 0.6)], {"warmup": (0.0, 1.0)}, (0.0, 1.0))
    run = harness.Run(1.0, [_rec(0.0, 1.0, 0.5)], trace, _rec(0.0, 1.0, 0.5), None)
    assert harness.reader(name)(run) is None
    assert "no tracer" in capsys.readouterr().err


# ------------------------------------------------------- idle attribution
def _span(i, name, start, end, parent=None, job=7):
    return tracing.Span(i, name, int(start * 1e9), int(end * 1e9), parent, job)


SPANS = [_span(0, "job", 0.0, 10.0), _span(1, "warmup", 1.0, 6.0, 0),
         _span(2, "step", 1.0, 3.0, 1), _span(3, "adapt.tune", 2.0, 2.5, 2),
         _span(4, "step", 3.0, 5.0, 1), _span(5, "adapt.mass", 4.0, 5.0, 4),
         _span(6, "sampling", 6.0, 9.0, 0)]


def test_innermost_spans_split_the_clock():
    segs = program.innermost(SPANS)
    assert [(pytest.approx(s), pytest.approx(e), n) for s, e, n in segs] == [
        (0.0, 1.0, "job"), (1.0, 2.0, "step"), (2.0, 2.5, "adapt.tune"), (2.5, 3.0, "step"),
        (3.0, 4.0, "step"), (4.0, 5.0, "adapt.mass"), (5.0, 6.0, "warmup"),
        (6.0, 9.0, "sampling"), (9.0, 10.0, "job")]


def test_idle_time_goes_to_the_innermost_span():
    ops = [("a", 0.5, 1.5), ("b", 1.8, 2.2), ("c", 2.4, 4.5), ("d", 5.5, 8.0)]
    assert program.idle_intervals(ops, 1.0, 6.0) == [(1.5, 1.8), (2.2, 2.4), (4.5, 5.5)]
    idle = program.idle_by_span(ops, program.innermost(SPANS), [(1.0, 6.0)])
    assert idle == pytest.approx({"step": 0.3, "adapt.tune": 0.2, "adapt.mass": 0.5,
                                  "warmup": 0.5})
    whole = program.idle_by_span(ops, program.innermost(SPANS), [(-1.0, 11.0)])
    assert whole[None] == pytest.approx(1.0 + 1.0)            # before and after the job
    assert whole["job"] == pytest.approx(0.5 + 1.0)


def test_adapt_idle_pct_reads_the_profiled_job(fresh, monkeypatch, capsys):
    ops = [("a", 0.5, 1.5), ("b", 1.8, 2.2), ("c", 2.4, 4.5), ("d", 5.5, 8.0)]
    traced = _rec(-0.1, 10.1, 5.0)
    trace = Summary(ops, traced["spans"], (-0.1, 10.1))
    other = _span(99, "step", 20.0, 21.0, None, job=3)          # another job's span
    tracing._ring.extend([list(s) + [None] for s in SPANS + [other]])
    tracing._reports.append({"name": "MCJob.run_preconditioned", "job": 7, "t0": 0.0,
                             "t1": 10.0, "phases": {}, "counters": {}})
    run = harness.Run(1.0, [], trace, traced, None)
    assert harness.reader("adapt_idle_pct")(run) == pytest.approx(100 * 0.7 / 1.5)
    err = capsys.readouterr().err
    assert "7 program spans in the profiled job, 0 outside its window" in err
    assert "adapt.mass: 0.500000" in err
    run.trace = None
    assert harness.reader("adapt_idle_pct")(run) is None
