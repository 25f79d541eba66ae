"""Host microseconds a call in K1's wrapper (``k1.host_ns``: ``ops/logreg.py``'s
``logreg_value_grad`` on the card), in the init and warmup phases of the
window's jobs, where the eager steps call it (the program's job reports).
The launch's host cost, which sets the pace of the eager warmup."""

import sys

from portbench import program


def read(run):
    reports = program.job_reports(run, "k1_host_us_per_call")
    if reports is None:
        return None
    warm = [p for r in reports for ph in ("init", "warmup") for p in program.phases(r, ph)]
    calls = sum(program.summed(p["counters"], "k1.host_ns") for p in warm)
    if not calls:
        print("# k1_host_us_per_call: no K1 call in the warmup phases: not reported",
              file=sys.stderr)
        return None
    return 1e-3 * sum(program.summed(p["counters"], "k1.host_ns", 1) for p in warm) / calls
