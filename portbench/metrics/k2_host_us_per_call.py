"""Host microseconds a call in K2's wrapper (``k2.host_ns``: ``ops/keyed.py``'s
``draws`` on the card), in the init and warmup phases of the
window's jobs, where the eager steps call it (the program's job reports).
The launch's host cost, which sets the pace of the eager warmup."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "k2_host_us_per_call")
    if reports is None:
        return None
    warm = [p for r in reports for ph in ("init", "warmup") for p in program.phases(r, ph)]
    calls = sum(program.summed(p["counters"], "k2.host_ns") for p in warm)
    if not calls:
        print("# k2_host_us_per_call: no K2 call in the warmup phases: not reported",
              file=sys.stderr)
        return None
    return 1e-3 * sum(program.summed(p["counters"], "k2.host_ns", 1) for p in warm) / calls
