"""Host reads a warmup step, over every site: the ``host_read.*`` counters
(the leapfrog's leap counts, the step-size search, ChEES's scalar copies,
synchronisations, the check-in) in the init and warmup phases of the
window's jobs over the warmup phases' steps (the program's job reports).
The inside counterpart of ``warmup_syncs_per_step``."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "warmup_host_reads_per_step")
    if reports is None:
        return None
    warm = [p for r in reports for p in program.phases(r, "warmup")]
    steps = sum(p["steps"] or 0 for p in warm)
    if not steps:
        print("# warmup_host_reads_per_step: no warmup steps in the reports: not reported",
              file=sys.stderr)
        return None
    inits = [p for r in reports for p in program.phases(r, "init")]
    return sum(program.summed(p["counters"], "host_read.") for p in inits + warm) / steps
