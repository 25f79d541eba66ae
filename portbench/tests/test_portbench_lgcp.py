"""The LGCP cell (``lgcp64.chees_1k``, job kind ``chees_lgcp``) at its toy
size on the CPU (an 8 × 8 grid, 32 chains; ``portbench/conftest.py``): the
reference agrees with the program, and a whole run with the program broken
underneath reads ``correct`` false, once for each fault: the gradient 1% too
large, the factor's transpose in its place, and a step that returns its
state unchanged."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from portbench import harness
from portbench.tests.toy import toy_root

CELL = "lgcp64.chees_1k"


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy_lgcp"))


def _run(toy, seed=2**31 + 4242):
    return harness.run_cell(CELL, seed, 0.2, False, time.perf_counter(),
                            device=torch.device("cpu"), root=toy)


def test_toy_size_is_the_cpus(toy):
    c = harness.cell(CELL, toy)
    assert (c.config["grid"], c.config["dim"], c.traffic["chains"]) == (8, 64, 32)


def test_sound_run_reads_correct(toy):
    result, comparisons = _run(toy)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1
    assert {n for n, _, _ in comparisons} == set(harness.cell(CELL, toy).traffic["limits"])


def _gradient_altered(mp):
    from klara_tpu_torch.models import lgcp

    make = lgcp.lgcp_target

    def altered(*args, **kwargs):
        t = make(*args, **kwargs)
        vg = t.value_and_grad_fn

        def scaled(z):
            v, g = vg(z)
            return v, g * (1.0 + 1e-2)

        return dataclasses.replace(t, value_and_grad_fn=scaled)

    mp.setattr(lgcp, "lgcp_target", altered)


def _factor_transposed(mp):
    from klara_tpu_torch.models import lgcp

    make = lgcp.lgcp_target
    mp.setattr(lgcp, "lgcp_target",
               lambda counts, chol, *a, **k: make(counts, chol.T.contiguous(), *a, **k))


def _state_unchanged(mp):
    from klara_tpu_torch.samplers import hmc

    finish = hmc.HMC.finish

    def unchanged(self, state, *args, **kwargs):
        _, info = finish(self, state, *args, **kwargs)
        return state, info

    mp.setattr(hmc.HMC, "finish", unchanged)


FAULTS = {"gradient_altered": _gradient_altered, "factor_transposed": _factor_transposed,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_reads_incorrect(toy, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result, _ = _run(toy)
    assert result["correct"] is False, result["compared"]
