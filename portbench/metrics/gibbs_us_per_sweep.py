"""Microseconds a steady-state Gibbs sweep inside the program: the ``sweeps``
phase of the window's jobs (every sweep, through the overflow check) less
its graph set-up, the host time of its eager blocks and captures
(``graphs.eager_blocks``, ``graphs.captures``: what ``capture_s`` reads),
over the sweeps its eager blocks did not run (``graphs.eager_steps``); the
program's job reports.  ``sampling_us_per_sweep`` holds set-up too."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "gibbs_us_per_sweep")
    if reports is None:
        return None
    sweeps = [p for r in reports for p in program.phases(r, "sweeps")]
    steps = sum((p["steps"] or 0) - program.summed(p["counters"], "graphs.eager_steps")
                for p in sweeps)
    if not steps:
        print("# gibbs_us_per_sweep: no replayed sweeps in the reports: not reported",
              file=sys.stderr)
        return None
    ns = sum(1e9 * p["seconds"] - program.summed(p["counters"], "graphs.eager_blocks", 1)
             - program.summed(p["counters"], "graphs.captures", 1) for p in sweeps)
    return 1e-3 * ns / steps
