"""The benchmark's harness on the CPU: BENCHMARK.json against the contract,
every cell at toy size with its result line, cells and metrics added as
files only, and the refusals (no card, a forbidden module)."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.toy import toy_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.benchmark()


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= keys | {"bound"} and 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) <= keys | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert os.path.exists(os.path.join(harness.HERE, "metrics", f"{metric['name']}.py"))
    if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
        assert metric["better"] == "higher"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_e2e_and_a_layer(workload):
    c = harness.cell(workload)
    e2e = {m["name"] for m in c.e2e}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert os.path.exists(os.path.join(harness.HERE, "jobs", f"{c.traffic['kind']}.py"))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return toy_root(tmp_path_factory.mktemp("toy"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_at_toy_size(toy, workload, trace):
    """A whole run on the CPU: the result line's shape, and the reference
    agreeing with the program (``correct``).  With no card there is no
    device trace: a traced run reports the per-layer metrics that read
    spans and counters, and leaves out the device's."""
    result, comparisons = harness.run_cell(workload, 2**31 + 11, 0.5, trace,
                                           time.perf_counter(), device=torch.device("cpu"),
                                           root=toy)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared"
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1 and 0 <= result["failed"] <= result["attempted"]
    c = harness.cell(workload, toy)
    if trace:
        off_card = {m["name"] for m in c.per_layer if m["source"] != "device_trace"}
        assert off_card - {"warmup_syncs_per_step"} <= set(result["metrics"])
        assert set(result["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(result["metrics"]) == {m["name"] for m in c.e2e}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and 0 <= m["value"] < float("inf")
    json.dumps(result)
    assert comparisons and all(len(c) == 3 for c in comparisons)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_cell_and_metric_added_as_files_only(tmp_path):
    """A new cell (an entry and a traffic file) and a new per-layer metric
    (an entry and a reader) run with no edit to a file the harness has."""
    root = toy_root(tmp_path)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    traffic = harness.load_json(os.path.join(root, "portbench", "traffic", "gibbs_4k.json"))
    traffic.update(chains=16, sweeps=250)
    _write(os.path.join(root, "portbench", "traffic", "gibbs_toy.json"), json.dumps(traffic))
    bench["workloads"].append({"name": "rats.toy", "config": "rats", "traffic": "gibbs_toy",
                               "chips": 1, "why": "a toy cell added as files"})
    bench["per_layer"].append({"name": "toy_jobs", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "job driver",
                               "moves": "ess_per_s", "workloads": ["rats.toy"]})
    _write(os.path.join(root, "BENCHMARK.json"), json.dumps(bench))
    _write(os.path.join(root, "portbench", "metrics", "toy_jobs.py"),
           "def read(run):\n    return float(len(run.jobs))\n")
    script = ("import json, sys, time, torch\n"
              "from portbench import harness\n"
              "r, _ = harness.run_cell('rats.toy', 5, 0.2, True, time.perf_counter(),"
              " device=torch.device('cpu'), root='.')\n"
              "print(json.dumps(r))\n"
              "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": root + os.pathsep
                                                       + harness.ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    result, forbidden = json.loads(lines[-2]), json.loads(lines[-1])
    assert result["metrics"]["toy_jobs"]["value"] >= 1
    assert result["correct"] is True
    assert forbidden == []


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    """The check compares whole top-level names: the port's own name begins
    with the JAX package's and is not caught."""
    monkeypatch.setitem(sys.modules, "klara_tpu_torch_lookalike", sys)
    assert "klara_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "klara_tpu.core", sys)
    assert "klara_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert "jax" in harness.forbidden_modules()


def test_run_without_the_program_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/ gives no
    result."""
    root = toy_root(tmp_path)
    script = ("import sys, time, torch\nsys.path[:] = ['.'] + [p for p in sys.path[1:] "
              "if 'repo' not in p]\nfrom portbench import harness\n"
              "harness.run_cell('rats.gibbs_4k', 1, 0.2, False, time.perf_counter(), "
              "device=torch.device('cpu'), root='.')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                      if k != "PYTHONPATH"})
    assert out.returncode != 0 and "klara_tpu_torch" in out.stderr


def test_job_seeds_and_samples_follow_the_seed():
    big = 2**31 + 12345
    assert harness.job_seed(big, 0) != harness.job_seed(big, 1)
    assert harness.job_seed(big, 0) == harness.job_seed(big, 0) < 2**63
    a = harness.chain_sample(big, 0, 16384, 16)
    assert torch.equal(a, harness.chain_sample(big, 0, 16384, 16))
    assert a.numel() == 16 and int(a[0]) == 0 and int(a[-1]) == 16383
    assert len(set(a.tolist())) == 16


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_run_of_a_cell_holds_the_same_jobs(workload):
    """The window's job count follows from its length alone, and every seed
    meets each job of the pool once, in its own order."""
    traffic = harness.cell(workload).traffic
    n = harness.jobs_in_window(traffic, BENCH["run_seconds"])
    assert n >= 2 and harness.jobs_in_window(traffic, 0.1) == 1
    pools = [[harness.pool_seed(traffic, s, k, n) for k in range(n)]
             for s in (2**31 + 1, 2**31 + 2, 5)]
    assert all(sorted(p) == sorted(pools[0]) and len(set(p)) == n for p in pools)
    assert pools[0] != pools[1]
