"""Toy sizes of the cells added after ``tests/toy.py`` was frozen with the
benchmark's first cells: ``toy.TOY`` learns their traffic's cuts, and
``toy.toy_root`` also cuts a configuration's widths where a cell's toy
size needs it (the LGCP's grid), so that every cell the harness tests
runs at a size the CPU holds.  Loaded before any test module imports
``toy_root``.  The control test's ``CARD_SIZE`` learns the new traffics'
card sizes once the tests are collected."""

from __future__ import annotations

import json
import os

from portbench.tests import toy

TOY_TRAFFIC = {
    "chees_4k": dict(toy.TOY["chees_16k"]),
    "chees_1k": dict(chains=32, burnin=40, post=60, mass_period=10, warm_burnin=2,
                     warm_post=40, reference_chains=4, chees_check_steps=4,
                     warmup_replay_steps=25),
}
TOY_CONFIGS = {"lgcp64": dict(grid=8, dim=64, area=1.0 / 64)}
# the sizes at which ``test_portbench_control`` runs the new traffics on the
# card (chees_4k as chees_16k's there; the LGCP on its toy grid)
CARD_TRAFFIC = {
    "chees_4k": dict(chains=4096, burnin=150, post=600, warm_burnin=2, warm_post=40,
                     s1_replay_steps=51),
    "chees_1k": dict(chains=1024, burnin=100, post=100, warm_burnin=2, warm_post=40,
                     warmup_replay_steps=51),
}

for _name, _cut in TOY_TRAFFIC.items():
    toy.TOY.setdefault(_name, _cut)

_toy_root = toy.toy_root


def toy_root(tmp_path):
    root = _toy_root(tmp_path)
    for name, cut in TOY_CONFIGS.items():
        path = os.path.join(root, "portbench", "configs", f"{name}.json")
        config = toy.harness.load_json(path)
        config.update(cut)
        with open(path, "w") as f:
            json.dump(config, f)
    return root


toy_root.__doc__ = _toy_root.__doc__
toy.toy_root = toy_root


def pytest_collection_modifyitems(items):
    for item in items:
        sizes = getattr(getattr(item, "module", None), "CARD_SIZE", None)
        if isinstance(sizes, dict):
            for name, cut in CARD_TRAFFIC.items():
                sizes.setdefault(name, dict(cut))
