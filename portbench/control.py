"""Readings for the limits of ``correct``: the reference's numbers of one
job a seed, the program's own or with the cell's control in its place, all
seeds in one process (one set-up).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--control]

Prints one JSON line a seed: {"seed", "control", "compared": {name: value}}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from portbench import harness


def readings(name, seeds, control, device, root=harness.ROOT, log=sys.stderr):
    """[(seed, {name: value})] of one job a seed at the cell's own size."""
    c = harness.cell(name, root)
    kind = importlib.import_module(f"portbench.jobs.{c.traffic['kind']}")
    job = kind.Job(c.config, c.traffic, device)
    job.warm(harness.job_seed(seeds[0], -1))
    out = []
    for seed in seeds:
        sample = harness.chain_sample(seed, 0, c.traffic["chains"], c.traffic["reference_chains"])
        pick = harness.pick(seed, 0)
        t0 = time.perf_counter()
        if control:
            rec = kind.control_record(job, harness.job_seed(seed, 0), sample, c.config,
                                      c.traffic, device, pick)
        else:
            rec = job.run(harness.job_seed(seed, 0), sample, pick)
        t1 = time.perf_counter()
        got = {n: v for n, v, _ in kind.check([rec], c.config, c.traffic, device)}
        print(f"# seed {seed}: job {t1 - t0:.2f} s, check {time.perf_counter() - t1:.2f} s, "
              f"R-hat {rec['rhat']:.5f}", file=log, flush=True)
        out.append((seed, got))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, got in readings(args.workload, seeds, args.control, torch.device("cuda", 0)):
        print(json.dumps({"seed": seed, "control": args.control, "compared": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
