"""K1's share of its roofline, in %: the least time its launches' work needs
on the card (``work.k1_least_s``) over K1's device time in the profiled
job.  Nothing when the profile holds fewer K1 records than the wrapper
counted (dropped records: a short count would read a share too high)."""

import sys

from portbench import work

NAMES = ("logreg_value_grad_kernel",)
NEEDS = "trace"


def read(run):
    if run.trace is None:
        return None
    job = run.traced
    n, secs = run.trace.kernels(None, NAMES)
    if n != job["launches"]["k1"] or secs <= 0:
        print(f"# k1_roofline: {n} K1 records in the profile, {job['launches']['k1']} "
              "launches counted: not reported", file=sys.stderr)
        return None
    w = job["work"]
    return 100.0 * n * work.k1_least_s(w["chains"], w["n_data"], w["dim"]) / secs
