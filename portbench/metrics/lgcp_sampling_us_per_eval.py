"""Microseconds of the sampling phase an LGCP evaluation: the program's
sampling spans over the evaluations its replay-aware counter counted in
them, all jobs of the window (the program's job reports)."""

from portbench import evals, program


def read(run):
    reports = program.job_reports(run, "lgcp_sampling_us_per_eval")
    if reports is None:
        return None
    phases = [program.sampling_phase(r) for r in reports]
    n = evals.of(phases, "lgcp_sampling_us_per_eval")
    if not n:
        return None
    return 1e6 * sum(p["seconds"] for p in phases) / n
