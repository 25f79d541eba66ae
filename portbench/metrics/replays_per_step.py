"""Graph replays a sampling step: the ``graphs.replays.*`` counters in the
sampling phase (stage 2's) of the window's jobs over its steps (the
program's job reports)."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "replays_per_step")
    if reports is None:
        return None
    sampling = [program.sampling_phase(r) for r in reports]
    if any(p is None or not p["steps"] for p in sampling):
        print("# replays_per_step: a job has no sampling phase: not reported", file=sys.stderr)
        return None
    return sum(program.summed(p["counters"], "graphs.replays.") for p in sampling) / sum(
        p["steps"] for p in sampling)
