"""The program's own trace, read beside the benchmark's records: the job
reports and span records of ``klara_tpu_torch.utils.tracing``.

A window job's report is the one whose ``[t0, t1]`` lies inside the job's
record ``spans`` (both on ``time.perf_counter``); the warm job, the job
under sync debug mode and the profiled job ran outside every window job's
spans, so none of them matches one.  Where the program has no tracer, or a
job has not exactly one report, a reader says why on standard error and
reports nothing.

The idle attribution: the device's idle time (outside the union of the
profile's operations) inside a time range, split by the innermost program
span open at each instant.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict


def _tracing(who):
    try:
        from klara_tpu_torch.utils import tracing
    except ImportError as e:
        print(f"# {who}: the program has no tracer ({e}): not reported", file=sys.stderr)
        return None
    return tracing


def window_of(rec):
    """(t0, t1) of a job record: from its first span's start to its last's end."""
    spans = rec["spans"].values()
    return min(s for s, _ in spans), max(e for _, e in spans)


def match(rec, reports):
    """The reports that lie inside job record ``rec``'s spans."""
    t0, t1 = window_of(rec)
    return [r for r in reports if t0 <= r["t0"] and r["t1"] <= t1]


def job_reports(run, who):
    """The report of each of the window's jobs, or None (said why)."""
    tracing = _tracing(who)
    if tracing is None:
        return None
    reports = tracing.reports()
    out = []
    for k, rec in enumerate(run.jobs):
        found = match(rec, reports)
        if len(found) != 1:
            print(f"# {who}: window job {k} has {len(found)} program reports, not one: "
                  "not reported", file=sys.stderr)
            return None
        out.append(found[0])
    return out


def traced_report(run, who):
    """(the profiled job's report, the tracer) or None (said why)."""
    tracing = _tracing(who)
    if tracing is None or run.traced is None:
        return None
    found = match(run.traced, tracing.reports())
    if len(found) != 1:
        print(f"# {who}: the profiled job has {len(found)} program reports, not one: "
              "not reported", file=sys.stderr)
        return None
    return found[0], tracing


def phases(report, last):
    """The report's phases whose path ends in ``last`` (``init`` matches
    ``stage1.init`` and ``init``)."""
    return [p for path, p in report["phases"].items() if path.split(".")[-1] == last]


def summed(counters, prefix, field=0):
    """The sum of field ``field`` (0: count, 1: ns) of the counters whose name
    starts with ``prefix``."""
    return sum(c[field] for name, c in counters.items() if name.startswith(prefix))


def sampling_phase(report):
    """The phase that sampled: stage 2's where the job has stages."""
    ph = report["phases"]
    return ph.get("stage2.sampling") or ph.get("sampling")


# ------------------------------------------------------- idle attribution
def innermost(spans):
    """[(start, end, name)] on the seconds of the host clock: the innermost
    span open at each instant, for properly nested ``spans`` (records of
    ``tracing.spans()``, closed ones)."""
    out, stack, t = [], [], None
    events = sorted(((s.start, -s.end, s) for s in spans if s.end is not None),
                    key=lambda e: (e[0], e[1]))

    def emit(until):
        if stack and t is not None and until > t:
            out.append((t * 1e-9, until * 1e-9, stack[-1].name))

    for start, _, s in events:
        while stack and stack[-1].end <= start:
            emit(stack[-1].end)
            t = stack.pop().end
        emit(start)
        stack.append(s)
        t = start
    while stack:
        emit(stack[-1].end)
        t = stack.pop().end
    return out


def idle_intervals(ops, t0, t1):
    """[(start, end)] of [t0, t1) in which no device operation ran; ``ops``
    (name, start, end) by start."""
    out, end = [], t0
    for _, s, e in ops:
        if e <= t0:
            continue
        if s >= t1:
            break
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if t1 > end:
        out.append((end, t1))
    return out


def idle_by_span(ops, segments, ranges):
    """{innermost span name: device idle seconds} inside ``ranges`` [(t0, t1)];
    idle time outside every span goes under ``None``.  ``segments`` as
    ``innermost`` gives them (by start, not overlapping)."""
    out = defaultdict(float)
    ends = [e for _, e, _ in segments]
    for t0, t1 in ranges:
        for a, b in idle_intervals(ops, t0, t1):
            covered = 0.0
            for k in range(bisect.bisect_right(ends, a), len(segments)):
                s, e, name = segments[k]
                if s >= b:
                    break
                d = min(b, e) - max(a, s)
                out[name] += d
                covered += d
            if b - a > covered:
                out[None] += b - a - covered
    return dict(out)
