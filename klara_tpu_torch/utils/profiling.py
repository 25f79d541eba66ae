"""Profiling helper (counterpart of klara_tpu/utils/profiling.py)."""

from __future__ import annotations

import contextlib
import os
import time

import torch

from klara_tpu_torch.utils import tracing


def _sync_cuda():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace_profile(logdir: str | None = None, label: str = "klara_tpu_torch"):
    """Wall-time a block and print ``[label] seconds``, with the program's
    span recording on (``utils.tracing``: the block's spans are in
    ``tracing.spans()`` after it).  With ``logdir`` the block also runs under
    ``torch.profiler`` (the CPU, and CUDA where it is available) and its
    Chrome trace, the program's spans above its kernels, is written to
    ``logdir/<label>.trace.json`` (Perfetto, chrome://tracing).  Where CUDA
    is in use the clock stops after a synchronise.

        with trace_profile("traces"):
            chain = job.run(generator, x0)
    """
    t0 = time.perf_counter()
    with tracing.recording():
        if logdir is None:
            yield
        else:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                yield
                _sync_cuda()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, f"{label}.trace.json"))
    _sync_cuda()
    dt = time.perf_counter() - t0
    print(f"[{label}] {dt:.3f}s" + (f" (trace: {logdir})" if logdir else ""))
