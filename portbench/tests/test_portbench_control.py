"""Each cell's control on the card reads ``correct`` false: the program on
its path one precision below the configuration's (logreg: K1 in one TF32
pass, cuBLAS in TF32), or the reference in bfloat16 in its place (rats), at a
size a test run holds.  The readings at the cells' own sizes come from
``python3 -m portbench.control`` (``PERF.md``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import control, harness
from portbench.tests.toy import toy_root

CARD_SIZE = {
    "chees_16k": dict(chains=4096, burnin=150, post=600, warm_burnin=2, warm_post=40,
                      s1_replay_steps=51),
    "gibbs_4k": dict(chains=1024, sweeps=3000, burnin=500, warm_sweeps=200, warm_burnin=100),
}
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's lower precision is the card's TF32 path")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_control_reads_incorrect(card, tmp_path, workload):
    root = toy_root(tmp_path)
    c = harness.cell(workload, root)
    path = os.path.join(root, "portbench", "traffic", f"{c.spec['traffic']}.json")
    traffic = harness.load_json(path)
    traffic.update(CARD_SIZE[c.spec["traffic"]])
    with open(path, "w") as f:
        json.dump(traffic, f)
    limits = traffic["limits"]
    for _, got in control.readings(workload, SEEDS, True, card, root):
        assert any(got[n] > limits[n] for n in got), got
