"""K2's share of its roofline, in %: the bytes of the profiled job's keyed
draws, each written once (their parameters are numbers, not tensors), at
the HBM rate, over K2's device time.  Nothing when the profile holds fewer
K2 records than the wrapper counted, or the count is not the job's draw
schedule (then the bytes would not be the draws')."""

import sys

from portbench import work

NAMES = ("keyed_draws",)
NEEDS = "trace"


def read(run):
    if run.trace is None:
        return None
    job = run.traced
    n, secs = run.trace.kernels(None, NAMES)
    w = job["work"]
    if n != job["launches"]["k2"] or n != w["k2_launches"] or secs <= 0:
        print(f"# k2_roofline: {n} K2 records in the profile, {job['launches']['k2']} "
              f"launches counted, {w['k2_launches']} in the draw schedule: not reported",
              file=sys.stderr)
        return None
    return 100.0 * w["k2_bytes"] / work.HBM_BYTES_PER_S / secs
