"""The traced run's reading of the device: one whole job under torch.profiler
(CUDA activity only), reduced in memory to a bounded summary.

The job's host-clock spans (warmup, sampling) are mapped onto the trace by a
marker kernel launched right after a synchronise at the job's start.  Busy
time is the union of the device operations' intervals; a span's idle share
is one less its busy time over its length.  Host synchronisations are
counted in another run of the job, under torch's sync debug mode "warn"
and no profiler, each stamped with the host clock when it is raised.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import defaultdict

import torch

MARKER = "spin_kernel"   # torch.cuda._sleep's kernel
TOP = 10


@dataclasses.dataclass
class Summary:
    ops: list             # (name, start_s, end_s) on the host clock, by start
    spans: dict           # {phase: (t0, t1)} host clock
    window: tuple         # (t0, t1) of the traced job

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        return self.busy(*self.window)

    def _inside(self, t0, t1):
        for name, s, e in self.ops:
            if e > t0 and s < t1:
                yield name, max(s, t0), min(e, t1)

    def busy(self, t0, t1):
        """Seconds of [t0, t1) in which some device operation ran."""
        total, end = 0.0, t0
        for _, s, e in self._inside(t0, t1):
            if e > end:
                total += e - max(s, end)
                end = e
        return total

    def idle_share(self, phase):
        t0, t1 = self.spans[phase]
        return 1.0 - self.busy(t0, t1) / (t1 - t0)

    def kernels(self, phase=None, match=None):
        """(count, device seconds) of the operations whose name holds any of
        ``match`` (None: all), inside ``phase``'s span (None: the job)."""
        t0, t1 = self.window if phase is None else self.spans[phase]
        n, secs = 0, 0.0
        for name, s, e in self._inside(t0, t1):
            if match is None or any(m in name for m in match):
                n += 1
                secs += e - s
        return n, secs

    def breakdown(self):
        by_name = defaultdict(float)
        for name, s, e in self.ops:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps, end = [], self.window[0]
        for _, s, e in self.ops:
            if s > end:
                gaps.append((s - end, end))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((self.window[1] - end, end))
        gaps = sorted(gaps, reverse=True)[:TOP]
        return {"device_ops": [[n[:160], secs] for n, secs in top],
                "idle_gaps": [[f"{self._phase_at(t)} +{t - self.window[0]:.6f}s", g]
                              for g, t in gaps]}

    def _phase_at(self, t):
        for phase, (t0, t1) in self.spans.items():
            if t0 <= t < t1:
                return phase
        return "scoring"


def _device_events(prof):
    """(name, start_ns, end_ns) of every device operation in the profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda t: t[1])
    return out


def counted_syncs(fn, device):
    """``fn()`` (one job) under torch's sync debug mode "warn", with no
    profiler: (its record, the host-clock time of each synchronisation
    warned of)."""
    syncs = []

    def stamp(message, category, *args, **kwargs):
        if "synchroniz" in str(message):
            syncs.append(time.perf_counter())

    torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = stamp
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rec = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return rec, syncs


def profiled(fn, device):
    """``fn()`` (one job) under the profiler, CUDA activity only: (its
    record, a function that reduces the profile to a ``Summary``, to call
    once the window has closed)."""
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        h0 = time.perf_counter()
        torch.cuda._sleep(1000)
        rec = fn()
        torch.cuda.synchronize(device)
        h1 = time.perf_counter()

    def summary():
        events = _device_events(prof)
        marker = next((s for n, s, _ in events if MARKER in n), None)
        if marker is None:
            raise RuntimeError("the profile holds no marker kernel: the device trace is empty")
        ops = [(n, h0 + (s - marker) * 1e-9, h0 + (e - marker) * 1e-9)
               for n, s, e in events if MARKER not in n]
        return Summary(ops, rec["spans"], (h0, h1))

    return rec, summary
