"""Milliseconds a sampling step: the program's sampling spans over the steps,
all jobs of the window."""


def read(run):
    return 1e3 * sum(j["sampling_s"] for j in run.jobs) / sum(j["steps"] for j in run.jobs)
