"""Milliseconds of the adaptation hooks' own host time a warmup step: the
timed counters ``adapt.tune``, ``adapt.mass`` and ``adapt.chees`` in the
warmup phases of the window's jobs, less the host reads inside them (ChEES's
scalar copies, ``host_read.chees_scalars``, which wait for the step's device
work), over those phases' steps (the program's job reports)."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "adapt_ms_per_step")
    if reports is None:
        return None
    warm = [p for r in reports for p in program.phases(r, "warmup")]
    steps = sum(p["steps"] or 0 for p in warm)
    if not steps:
        print("# adapt_ms_per_step: no warmup steps in the reports: not reported",
              file=sys.stderr)
        return None
    ns = sum(program.summed(p["counters"], "adapt.", 1)
             - program.summed(p["counters"], "host_read.chees_scalars", 1) for p in warm)
    return 1e-6 * ns / steps
