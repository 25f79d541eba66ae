"""Microseconds of the init and warmup phases an LGCP evaluation: their
program spans over the evaluations the replay-aware counter counted in
them, all jobs of the window (the program's job reports).  Above
``lgcp_sampling_us_per_eval`` by what the warmup adds to the same
evaluations: the step-size search, the hooks, ChEES's scalar reads and
the per-step leap-count read."""

from portbench import evals, program


def read(run):
    reports = program.job_reports(run, "lgcp_warmup_us_per_eval")
    if reports is None:
        return None
    phases = [p for r in reports for ph in ("init", "warmup") for p in program.phases(r, ph)]
    n = evals.of(phases, "lgcp_warmup_us_per_eval")
    if not n:
        return None
    return 1e6 * sum(p["seconds"] for p in phases) / n
