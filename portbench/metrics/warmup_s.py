"""Warmup seconds a job: the benchmark's synchronised wall of the job's call
less the program's sampling span, averaged over the window's jobs."""


def read(run):
    return sum(j["wall_s"] - j["sampling_s"] for j in run.jobs) / len(run.jobs)
