"""At tiny sizes on the CPU the port and the reference agree for each
traffic, and the result line has exactly the contract's keys."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH, TINY, tiny_name
from portbench import run

CELLS = sorted(TINY)
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(bench_copy, cell, trace=False, seed=123456789):
    return run.run_cell(tiny_name(cell), seed, 0.3, trace, "cpu",
                        root=bench_copy.parent, bench_dir=bench_copy)


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(bench_copy, cell):
    res = _run(bench_copy, cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    for name, row in res["check"].items():
        assert row["value"] <= row["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_result_keys_untraced(bench_copy, cell):
    res = _run(bench_copy, cell)
    assert set(res) == KEYS | {"check"}
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"knn_qps", "batch_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.loads(json.dumps(res))


def test_result_keys_traced(bench_copy):
    res = _run(bench_copy, "sift1m-flat.exact-q256-k10", trace=True)
    assert set(res) == KEYS | {"check", "breakdown"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10
    # no device on the CPU: only the metrics that need none are read
    assert set(res["metrics"]) == {"rows_scanned_per_query",
                                   "roofline_share"}
    assert res["metrics"]["rows_scanned_per_query"]["value"] == 4000


def test_same_seed_same_index(bench_copy):
    """The same seed builds the same index from the same rows (which
    batches are compared depends on how many the window finished)."""
    a = _run(bench_copy, "snb100-faces.join-q1024-k100", seed=77)
    b = _run(bench_copy, "snb100-faces.join-q1024-k100", seed=77)
    for name in ("centroid_err", "assign_gap"):
        assert a["check"][name] == b["check"][name]


@pytest.mark.parametrize("where", ["repo", "paths_only"])
def test_no_card_no_result(tmp_path, where):
    """Without a card the command exits with an error and prints nothing on
    standard output, in the repository and in a directory that holds only
    BENCHMARK.json and the benchmark's files."""
    root = BENCH.parent
    if where == "paths_only":
        import shutil
        shutil.copytree(BENCH, tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
        root = tmp_path
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sift1m-flat.probe8-q256-k10", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
