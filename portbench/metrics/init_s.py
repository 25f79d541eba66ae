"""Seconds of a job's init phases (the sampler's init, the step-size search
among it: ``stage1.init`` and ``stage2.init``), averaged over the window's
jobs: the program's job reports (``klara_tpu_torch.utils.tracing``)."""

from portbench import program


def read(run):
    reports = program.job_reports(run, "init_s")
    if reports is None:
        return None
    return sum(p["seconds"] for r in reports for p in program.phases(r, "init")) / len(reports)
