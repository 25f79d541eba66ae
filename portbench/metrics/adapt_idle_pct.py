"""The adaptation hooks' share of the device's idle time in warmup, in %:
of the profiled job's device idle time (outside the union of the profile's
operations) inside the program's ``warmup`` spans, the share during which
the innermost program span is an ``adapt.*`` span (the hooks' own host
work: their waits for the device are ``host_read.*`` spans inside them,
innermost while they last).  The program's spans and the device trace
share the host clock (``portbench.trace``'s marker).  Prints on standard
error the profiled job's device idle seconds by innermost span, the whole
job's and warmup's."""

import sys

from portbench import program

NEEDS = "trace"


def read(run):
    if run.trace is None:
        return None
    got = program.traced_report(run, "adapt_idle_pct")
    if got is None:
        return None
    report, tracing = got
    spans = [s for s in tracing.spans() if s.job == report["job"]]
    if not any(s.name == "job" for s in spans):
        print("# adapt_idle_pct: the profiled job's spans are not all in the ring: "
              "not reported", file=sys.stderr)
        return None
    t0, t1 = program.window_of(run.traced)
    outside = sum(s.end is None or s.start * 1e-9 < t0 or s.end * 1e-9 > t1 for s in spans)
    segments = program.innermost(spans)
    ops = run.trace.ops
    whole = program.idle_by_span(ops, segments, [(report["t0"], report["t1"])])
    warmup = [(s.start * 1e-9, s.end * 1e-9) for s in spans if s.name == "warmup"]
    idle = program.idle_by_span(ops, segments, warmup)
    for what, table in (("the profiled job", whole), ("its warmup spans", idle)):
        rows = ", ".join(f"{k}: {v:.6f}" for k, v in sorted(
            table.items(), key=lambda kv: -kv[1]))
        print(f"# adapt_idle_pct: device idle s in {what} by innermost span "
              f"({sum(table.values()):.6f} s): {rows}", file=sys.stderr)
    print(f"# adapt_idle_pct: {len(spans)} program spans in the profiled job, "
          f"{outside} outside its window", file=sys.stderr)
    total = sum(idle.values())
    if total <= 0:
        print("# adapt_idle_pct: no idle time in warmup: not reported", file=sys.stderr)
        return None
    return 100.0 * sum(v for k, v in idle.items() if k and k.startswith("adapt.")) / total
