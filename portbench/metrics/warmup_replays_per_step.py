"""Graph replays a warmup step: the ``graphs.replays.*`` counters in the
warmup phases (both stages') of the window's jobs over their steps (the
program's job reports).  0 where the warmup runs its steps eagerly; the
counterpart of ``replays_per_step`` for the warmup."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "warmup_replays_per_step")
    if reports is None:
        return None
    warm = [p for r in reports for p in program.phases(r, "warmup")]
    steps = sum(p["steps"] or 0 for p in warm)
    if not steps:
        print("# warmup_replays_per_step: no warmup steps in the reports: not reported",
              file=sys.stderr)
        return None
    return sum(program.summed(p["counters"], "graphs.replays.") for p in warm) / steps
