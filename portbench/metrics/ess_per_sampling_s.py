"""Effective samples per second of sampling: the ESS of the window's jobs
that passed the R-hat gate over the program's sampling spans of all its
jobs (``run_preconditioned``'s ``sampling_seconds``)."""


def read(run):
    return sum(j["min_ess"] for j in run.jobs if j["passed"]) / sum(j["sampling_s"]
                                                                   for j in run.jobs)
