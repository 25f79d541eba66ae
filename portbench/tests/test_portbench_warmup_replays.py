"""The reader of ``warmup_replays_per_step`` (``portbench/metrics/
warmup_replays_per_step.py``) on synthetic job reports: 0 where the warmup
runs eagerly, the warmup phases' graph replays over their steps where it
replays graph units, and nothing reported, nothing raised, where the
program has no tracer."""

from __future__ import annotations

import sys

import pytest

from portbench import harness
from portbench.tests.test_portbench_program import _chees_report, _rec, _window
from portbench.tests.test_portbench_program import fresh  # noqa: F401  (fixture)
from portbench.trace import Summary


def _graph_warmup_report(job, t0):
    """``_chees_report`` with each stage's warmup replayed as graph units: 100
    heads and tails, 700 leaps (50 masked), one eager block and one capture
    a kind less."""
    report = _chees_report(job, t0)
    for s in (1, 2):
        report["phases"][f"stage{s}.warmup"]["counters"].update({
            "graphs.replays.warmup head": [99, 10**6], "graphs.replays.warmup tail": [98, 10**6],
            "graphs.replays.warmup leap": [648, 10**7],
            "graphs.replays.warmup masked leap": [48, 10**6],
            "graphs.eager_blocks": [4, 10**7], "graphs.captures": [4, 10**7]})
    return report


def test_the_eager_warmup_reads_zero(fresh):  # noqa: F811
    assert harness.reader("warmup_replays_per_step")(_window(_chees_report, fresh)) == 0.0


def test_the_graph_warmup_reads_its_replays_over_its_steps(fresh):  # noqa: F811
    run = _window(_graph_warmup_report, fresh)
    # each stage's 893 replays over its 100 warmup steps; sampling's are not counted
    assert harness.reader("warmup_replays_per_step")(run) == pytest.approx(2 * 893 / 200)
    assert harness.reader("replays_per_step")(run) == pytest.approx(350 / 50)


def test_without_the_tracer_nothing_is_reported_and_nothing_raised(monkeypatch, capsys):
    """The parent of this change reads through the same ``program`` module:
    where the program has no ``utils.tracing`` the reader returns None and
    says why."""
    import klara_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "klara_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(klara_tpu_torch.utils, "tracing")
    trace = Summary([("k", 0.5, 0.6)], {"warmup": (0.0, 1.0)}, (0.0, 1.0))
    run = harness.Run(1.0, [_rec(0.0, 1.0, 0.5)], trace, _rec(0.0, 1.0, 0.5), None)
    assert harness.reader("warmup_replays_per_step")(run) is None
    assert "no tracer" in capsys.readouterr().err
