"""The benchmark's driver: one cell, one run, in this process.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(configuration, traffic, chips), ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its job kind), ``jobs/<kind>.py``
(``Job`` and ``check``) and ``metrics/<metric>.py`` (``read(run)``) for
each metric the cell reports.  A run: set-up (the program's target, a warm
job), then a window of a fixed count of whole jobs (``jobs_in_window``),
each job of the cell's pool once, in an order the run's seed picks; with
``--trace 1`` the window's first job again under sync debug mode and under
the profiler, as the per-layer readers need; then the reference's check of
every job the window and the profiler ran.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Any, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "klara_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict
    e2e: list
    per_layer: list


def cell(name: str, root=ROOT) -> Cell:
    """The cell ``name`` and the metrics it reports, from ``BENCHMARK.json``."""
    bench = benchmark(root)
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise SystemExit(f"unknown workload {name!r}: {sorted(specs)}")
    spec = specs[name]
    base = os.path.join(root, "portbench")
    config = load_json(os.path.join(base, "configs", f"{spec['config']}.json"))
    traffic = load_json(os.path.join(base, "traffic", f"{spec['traffic']}.json"))

    def mine(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (mine(m) if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, spec, config, traffic, e2e, per_layer)


def job_seed(seed: int, k: int) -> int:
    """The generator seed of the window's k-th job (k = -1: the warm job)."""
    return (seed * 1_000_003 + 7919 * (k + 2)) % (1 << 63)


def jobs_in_window(traffic: dict, seconds: float) -> int:
    """The whole jobs a window of ``seconds`` holds: the traffic's
    ``job_seconds`` (one job's wall on the card it was sized on) into it,
    at least one.  The count is fixed by the window's length alone, so
    every run of a cell does the same work."""
    return max(1, round(seconds / traffic["job_seconds"]))


def pool_seed(traffic: dict, seed: int, k: int, n: int) -> int:
    """The generator seed of the window's k-th job of ``n``: the traffic's
    pool of ``n`` jobs (fixed by its ``pool_seed``), each met once, in turn
    from a place the run's seed picks.  Every run's window holds the same
    jobs in another order."""
    return job_seed(traffic["pool_seed"], (seed + k) % n)


def pick(seed: int, k: int) -> torch.Generator:
    """The generator of job k's other sampled choices (such as the steps
    whose adaptation the reference recomputes), drawn from the run's seed."""
    return torch.Generator().manual_seed(job_seed(seed, k) ^ 0x2545F491)


def chain_sample(seed: int, k: int, chains: int, n: int):
    """The ``n`` chains of job k the reference replays, drawn from the seed,
    chain 0 and the last always among them."""
    g = torch.Generator().manual_seed(job_seed(seed, k) ^ 0x5DEECE66D)
    pick = torch.randperm(chains - 2, generator=g)[: max(0, n - 2)] + 1
    return torch.cat([torch.tensor([0, chains - 1]), pick]).sort().values


@dataclasses.dataclass
class Run:
    """What the metric readers read: the set-up seconds, the window's job
    records and, in a traced run on the card, the profile's summary and the
    record of the job it profiled, and (record, host-clock times of the
    synchronisations) of a job run under torch's sync debug mode; both run
    after the window, the window's first job again, so the window's jobs
    run as in an untraced run."""

    setup_s: float
    jobs: list
    trace: Any = None
    traced: Any = None
    synced: Any = None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def reader(name: str):
    return importlib.import_module(f"portbench.metrics.{name}").read


def needs(per_layer) -> set:
    """What the per-layer readers need beyond the window's records: a
    reader module's ``NEEDS`` ("trace": a profiled job; "syncs": a job
    under torch's sync debug mode)."""
    return {getattr(importlib.import_module(f"portbench.metrics.{m['name']}"), "NEEDS", None)
            for m in per_layer} - {None}


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_process: float,
             device: Optional[torch.device] = None, root=ROOT, log=sys.stderr):
    """One run of cell ``name``; returns (result dict, comparisons)."""
    c = cell(name, root)
    device = device or torch.device("cuda", 0)
    kind = importlib.import_module(f"portbench.jobs.{c.traffic['kind']}")
    t_import = time.perf_counter()
    job = kind.Job(c.config, c.traffic, device)
    t_target = time.perf_counter()
    job.warm(job_seed(c.traffic["pool_seed"], -1))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    print(f"# set-up {setup_s:.4f} s: imports {t_import - t_process:.4f} s, target "
          f"{t_target - t_import:.4f} s, warm job {t_window - t_target:.4f} s",
          file=log, flush=True)
    n_jobs = jobs_in_window(c.traffic, seconds)
    n_sample = c.traffic["reference_chains"]

    def run_job(k):
        sample = chain_sample(seed, k, c.traffic["chains"], n_sample)
        return job.run(pool_seed(c.traffic, seed, k, n_jobs), sample, pick(seed, k))

    records = []
    for k in range(n_jobs):
        rec = run_job(k)
        records.append(rec)
        print(f"# job {k}: wall {rec['wall_s']:.4f} s, sampling {rec['sampling_s']:.4f} s, "
              f"min ESS {rec['min_ess']:.1f}, R-hat {rec['rhat']:.5f}", file=log, flush=True)
    print(f"# window {time.perf_counter() - t_window:.4f} s, {n_jobs} jobs", file=log,
          flush=True)
    traced = reduce_trace = synced = None
    wanted = needs(c.per_layer) if trace else set()
    if "syncs" in wanted and device.type == "cuda":
        # the window's first job again, under sync debug mode alone
        from portbench import trace as tracing

        synced = tracing.counted_syncs(lambda: run_job(n_jobs), device)
    if "trace" in wanted and device.type == "cuda":
        # the window's first job again, profiled once the window has closed
        from portbench import trace as tracing

        traced, reduce_trace = tracing.profiled(lambda: run_job(n_jobs), device)
        print(f"# profiled job: wall {traced['wall_s']:.4f} s, sampling "
              f"{traced['sampling_s']:.4f} s (the window's run of it: "
              f"{records[0]['wall_s']:.4f} s, {records[0]['sampling_s']:.4f} s)",
              file=log, flush=True)
    info = device_info(device)
    summary = reduce_trace() if reduce_trace else None
    del job
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checked = records + ([traced] if traced else [])
    comparisons = kind.check(checked, c.config, c.traffic, device)
    print(f"# reference check: {time.perf_counter() - t_ref:.2f} s", file=log, flush=True)
    run = Run(setup_s, records, summary, traced, synced)
    metrics = {}
    for m in (c.per_layer if trace else c.e2e):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and summary is not None:
        info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    correct = all(value <= limit for _, value, limit in comparisons)
    result = {
        "correct": correct,
        "attempted": len(checked),
        "failed": sum(not r["passed"] for r in checked),
        "metrics": metrics,
        "device": info,
    }
    if trace and summary is not None:
        result["breakdown"] = summary.breakdown()
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in comparisons}
    return result, comparisons
