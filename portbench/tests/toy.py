"""Toy copies of the benchmark for the CPU tests: the cells' traffic cut to a
few chains and steps, in a directory of their own."""

from __future__ import annotations

import json
import os
import shutil

from portbench import harness

TOY = {
    "chees_16k": dict(chains=64, burnin=40, post=60, mass_period=10, warm_burnin=2,
                      warm_post=40, reference_chains=4, chees_check_steps=4,
                      s1_replay_steps=25),
    "gibbs_4k": dict(chains=32, sweeps=300, burnin=100, warm_sweeps=210, warm_burnin=10,
                     reference_chains=4),
}


def toy_root(tmp_path):
    """A copy of BENCHMARK.json and portbench/ under ``tmp_path`` with every
    traffic file cut to its toy size (``TOY``)."""
    root = str(tmp_path)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(harness.ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cut in TOY.items():
        path = os.path.join(root, "portbench", "traffic", f"{name}.json")
        traffic = harness.load_json(path)
        traffic.update(cut)
        with open(path, "w") as f:
            json.dump(traffic, f)
    return root
