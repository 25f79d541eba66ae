"""Host seconds a job spends setting up its graphs: the timed counters
``graphs.eager_blocks`` (the first block of each kind, run eagerly) and
``graphs.captures``, averaged over the window's jobs (the program's job
reports)."""

from portbench import program


def read(run):
    reports = program.job_reports(run, "capture_s")
    if reports is None:
        return None
    ns = sum(program.summed(r["counters"], name, 1) for r in reports
             for name in ("graphs.eager_blocks", "graphs.captures"))
    return 1e-9 * ns / len(reports)
