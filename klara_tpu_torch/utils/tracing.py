"""The port's tracer: span records, counters and job reports, all in memory.

Clock.  Everything is read on ``time.perf_counter_ns``: the clock a device
trace is mapped onto by a marker kernel launched after a synchronise (a
profiled job's host time ``h0`` and the marker's device time line up), so
the program's spans and a device trace share a clock.  Job reports give
their times in seconds of ``time.perf_counter``, the same clock.

Spans (``span``, ``timed``, ``Phases``): a record (id, name, start, end,
parent, job) in a bounded ring (``spans()``, the last ``RING``), made only
while recording is on: inside ``recording()``, or while a torch profiler
session is active.  Off, a span site costs one check of that flag.  Under a
profiler each span also opens ``torch.profiler.record_function(name)``, so
a Chrome trace shows the program's spans above its kernels.

Counters (always on): ``count(name, n)`` counts events; a timed counter
(``timed``, ``add``) keeps calls and host nanoseconds.  The module counters
the repo already has (K1's and K2's launches, the graph counters, the mesh's
collectives, the slice sampler's host reads) stay where they are;
``counters()`` reads them beside the tracer's own, named by their module
(``ops.logreg.KERNEL_LAUNCHES``, ``ops.keyed.LAUNCHES_BY_MODE.normal``).

Job reports (always on): the outermost call of ``MCJob.run``, ``resume``,
``run_phased``, ``run_preconditioned`` and of ``GibbsJob.run`` and
``resume`` appends one report to a bounded deque (``reports()``, the last
``REPORTS``): a dict of its ``name``, ``job`` (a serial number, which its
spans carry), ``t0`` and ``t1`` (seconds), its ``phases`` by path (such as
``stage1.init``, ``stage2.warmup``, ``sweeps``: each with ``t0``, ``t1``,
``seconds``, ``steps``, ``calls`` and the deltas of every counter that
moved) and the job's total ``counters``; a counter's delta is ``[count,
ns]``.

Names the program uses: spans ``job``, phases (``stage1``, ``precondition``,
``stage2``, ``init``, ``warmup``, ``sampling``, ``steps``, ``setup``,
``sweeps``), ``step`` (an eager MCJob step), ``block`` (a block of graph
units), ``eager_block``, ``capture``, ``replay.<kind>``, ``adapt.*`` and
``host_read.*``; timed counters ``adapt.tune``, ``adapt.mass``,
``adapt.chees``, ``host_read.<site>`` (the host blocked on the device:
``leapfrog_bounds``, ``step_search``, ``chees_scalars`` inside
``adapt.chees``, ``block_bounds``, ``sync``, ``overflow``, ``checkin``),
``graphs.eager_blocks``, ``graphs.captures``, ``graphs.replays.<kind>``,
``k1.host_ns`` and ``k2.host_ns`` (host time inside the kernels'
wrappers; on the CPU, their plain versions'), ``factor.host_ns`` (inside an
evaluation through a factor, ``core.target.through_factor``, a span
``factor`` while recording); the count
``graphs.eager_steps``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import time
from typing import NamedTuple, Optional

import torch

RING = 1 << 18    # span records kept
REPORTS = 64      # job reports kept

_ns = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled

# the repo's module counters, read (never moved) by ``counters()``
_MODULE_COUNTERS = (
    ("core.target", "FACTOR_EVALUATIONS"),
    ("ops.logreg", "KERNEL_LAUNCHES"),
    ("ops.keyed", "KERNEL_LAUNCHES"),
    ("ops.keyed", "LAUNCHES_BY_MODE"),
    ("jobs.graphs", "GRAPHS_CAPTURED"),
    ("jobs.graphs", "GRAPH_REPLAYS"),
    ("jobs.graphs", "REPLAYED_LAUNCHES"),
    ("parallel.mesh", "COLLECTIVES"),
    ("samplers.slice_sampler", "HOST_READS"),
)

_recording = 0                              # depth of ``recording()`` blocks
_ring = collections.deque(maxlen=RING)      # span records: [id, name, start, end, parent, job, fn]
_stack = []                                 # open span records
_ids = itertools.count()
_counters = {}                              # name -> [count, ns]
_reports = collections.deque(maxlen=REPORTS)
_jobs = itertools.count()
_job = None                                 # the open job's _Job
_path = []                                  # the open phases' names


class Span(NamedTuple):
    """A span record: ``start`` and ``end`` in ns of ``time.perf_counter_ns``
    (``end`` None while open), ``parent`` the enclosing span's id, ``job``
    the serial number of the job it ran in (None outside a job)."""

    id: int
    name: str
    start: int
    end: Optional[int]
    parent: Optional[int]
    job: Optional[int]


# ----------------------------------------------------------------- spans
def active() -> bool:
    """True while spans are recorded: inside ``recording()`` or under an
    active torch profiler."""
    return _recording > 0 or _profiling()


class recording:
    """Record spans inside this block (blocks nest)."""

    def __enter__(self):
        global _recording
        _recording += 1
        return self

    def __exit__(self, *exc):
        global _recording
        _recording -= 1


def _open(name, t=None):
    fn = None
    if _profiling():
        fn = torch.profiler.record_function(name)
        fn.__enter__()
    rec = [next(_ids), name, _ns() if t is None else t, None,
           _stack[-1][0] if _stack else None, None if _job is None else _job.id, fn]
    _stack.append(rec)
    _ring.append(rec)
    return rec


def _close(rec, t=None):
    rec[3] = _ns() if t is None else t
    if _stack and _stack[-1] is rec:
        _stack.pop()
    if rec[6] is not None:
        rec[6].__exit__(None, None, None)
        rec[6] = None


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rec = _open(self.name)
        return self

    def __exit__(self, *exc):
        _close(self.rec)


def span(name: str):
    """A span around a ``with`` block while recording; else nothing."""
    return _Span(name) if _recording or _profiling() else _NULL


def spans() -> list:
    """The ring's span records, oldest first."""
    return [Span(*r[:6]) for r in _ring]


# -------------------------------------------------------------- counters
def count(name: str, n: int = 1) -> None:
    """Count ``n`` events under ``name``."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = [0, 0]
    c[0] += n


def add(name: str, ns: int, n: int = 1) -> None:
    """A timed counter: ``n`` calls that took ``ns`` host nanoseconds."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = [0, 0]
    c[0] += n
    c[1] += ns


class timed:
    """A timed counter around a ``with`` block (its calls and host ns), and
    while recording a span of the same clock reads, named ``span`` (the
    counter's name by default)."""

    __slots__ = ("name", "span", "t", "rec")

    def __init__(self, name: str, span: Optional[str] = None):
        self.name = name
        self.span = name if span is None else span

    def __enter__(self):
        if _recording or _profiling():
            self.rec = _open(self.span)
            self.t = self.rec[2]
        else:
            self.rec, self.t = None, _ns()
        return self

    def __exit__(self, *exc):
        t = _ns()
        add(self.name, t - self.t)
        if self.rec is not None:
            _close(self.rec, t)


def counters() -> dict:
    """{name: (count, ns)} of the tracer's counters and the repo's module
    counters (their ns 0), as they stand."""
    out = {name: (c[0], c[1]) for name, c in _counters.items()}
    for mod, attr in _MODULE_COUNTERS:
        m = sys.modules.get(f"klara_tpu_torch.{mod}")
        if m is None:
            continue
        value = getattr(m, attr)
        if isinstance(value, dict):
            out.update({f"{mod}.{attr}.{k}": (v, 0) for k, v in value.items()})
        else:
            out[f"{mod}.{attr}"] = (value, 0)
    return out


def _delta(before, after) -> dict:
    out = {}
    for name, (n, ns) in after.items():
        n0, ns0 = before.get(name, (0, 0))
        if n != n0 or ns != ns0:
            out[name] = [n - n0, ns - ns0]
    return out


# ------------------------------------------------------------ job reports
class _Job:
    def __init__(self, name):
        self.name, self.id, self.phases = name, next(_jobs), {}

    def phase(self, path, t0, t1, steps, deltas):
        p = self.phases.get(path)
        if p is None:
            self.phases[path] = {"t0": t0 / 1e9, "t1": t1 / 1e9, "seconds": (t1 - t0) / 1e9,
                                 "steps": steps, "calls": 1, "counters": deltas}
            return
        p["t1"] = t1 / 1e9
        p["seconds"] += (t1 - t0) / 1e9
        p["calls"] += 1
        if steps is not None:
            p["steps"] = (p["steps"] or 0) + steps
        for name, (n, ns) in deltas.items():
            c = p["counters"].setdefault(name, [0, 0])
            c[0] += n
            c[1] += ns


class job:
    """The outermost call of a job's entry point: a report appended at its
    end (a call inside another job's adds nothing), and while recording a
    ``job`` span."""

    __slots__ = ("name", "outer", "t0", "before", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _job
        self.outer = _job is None
        if self.outer:
            _job = _Job(self.name)
            self.before = counters()
            self.rec = _open("job") if active() else None
            self.t0 = _ns() if self.rec is None else self.rec[2]
        return self

    def __exit__(self, *exc):
        global _job
        if not self.outer:
            return
        t1 = _ns()
        if self.rec is not None:
            _close(self.rec, t1)
        j, _job = _job, None
        _reports.append({"name": j.name, "job": j.id, "t0": self.t0 / 1e9, "t1": t1 / 1e9,
                         "phases": j.phases, "counters": _delta(self.before, counters())})


class Phases:
    """Consecutive phases of a job, each ending at the clock read that
    starts the next: ``enter(name, steps)`` ends the open phase and starts
    ``name``, ``close()`` ends the last; both return their read (ns).  A
    phase is a span while recording, and goes into the open job's report
    under its path (the enclosing phases' names, dot-joined)."""

    def __init__(self):
        self.name = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.name is not None:
            self.close()

    def enter(self, name: str, steps: Optional[int] = None) -> int:
        t = _ns()
        snap = counters() if _job is not None else None
        if self.name is None:
            _path.append(name)
        else:
            self._end(t, snap)
            _path[-1] = name
        self.name, self.steps, self.t, self.snap = name, steps, t, snap
        self.rec = _open(name, t) if active() else None
        return t

    def close(self) -> int:
        t = _ns()
        self._end(t, counters() if _job is not None else None)
        _path.pop()
        self.name = None
        return t

    def _end(self, t, snap):
        if self.rec is not None:
            _close(self.rec, t)
        if self.snap is not None:
            _job.phase(".".join(_path), self.t, t, self.steps, _delta(self.snap, snap))


def reports() -> list:
    """The last ``REPORTS`` job reports, oldest first."""
    return list(_reports)


def reset() -> None:
    """Forget the spans, the reports and the tracer's own counters (the
    module counters are reset where they live)."""
    _ring.clear()
    _reports.clear()
    _counters.clear()
