"""Microseconds a Gibbs sweep: the benchmark's clock around each job's run
over its sweeps (burnin included), all jobs of the window."""


def read(run):
    return 1e6 * sum(j["sampling_s"] for j in run.jobs) / sum(j["steps"] for j in run.jobs)
