"""Effective samples per second of whole jobs: the min-over-coordinates ESS
of the window's jobs that passed the R-hat gate, over the benchmark's
synchronised wall clock of all its jobs' calls (warmup included)."""


def read(run):
    return sum(j["min_ess"] for j in run.jobs if j["passed"]) / sum(j["wall_s"]
                                                                   for j in run.jobs)
