"""A copy of the benchmark with tiny cells, for CPU runs.

Each tiny cell keeps its real cell's traffic and limits and cuts only the
configuration's rows and queries, so a run on the CPU drives the real
harness, driver, comparison and metric readers in seconds.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: real cell -> its tiny copy's (rows, queries, vectors a bucket, batch)
TINY = {
    "sift1m-flat.probe8-q256-k10": (4000, 300, 400, 32),
    "snb100-faces.join-q1024-k100": (3000, 300, 100000, 32),
    "sift1m-flat.exact-q256-k10": (4000, 300, 400, 32),
}


def tiny_name(cell: str) -> str:
    cfg, traffic = cell.split(".", 1)
    return f"tiny-{cfg}.tiny-{traffic}"


def make_copy(dst: Path) -> Path:
    """``dst`` holding BENCHMARK.json (the tiny cells) and ``portbench/``
    (tiny configurations, traffic and limits beside the real ones);
    returns ``dst / "portbench"``."""
    bench_dir = dst / "portbench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    tiny_cells = []
    for cell, (n, nq, vpb, batch) in TINY.items():
        real = cells[cell]
        cfg = json.loads((bench_dir / "configs"
                          / f"{real['config']}.json").read_text())
        cfg["vectors"]["n"], cfg["n_queries"] = n, nq
        cfg["index"]["vectors_per_bucket"] = vpb
        tr = json.loads((bench_dir / "traffic"
                         / f"{real['traffic']}.json").read_text())
        tr["batch"], tr["check_batches"] = batch, 4
        tr["warmup_seconds"] = 0.0
        name = tiny_name(cell)
        c, t = name.split(".", 1)
        (bench_dir / "configs" / f"{c}.json").write_text(json.dumps(cfg))
        (bench_dir / "traffic" / f"{t}.json").write_text(json.dumps(tr))
        shutil.copy(bench_dir / "limits" / f"{cell}.json",
                    bench_dir / "limits" / f"{name}.json")
        tiny_cells.append({"name": name, "config": c, "traffic": t,
                           "chips": 1, "why": f"{cell} cut for the CPU"})
    spec["workloads"] += tiny_cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [tiny_name(w) for w in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    (dst / "src").symlink_to(REPO / "src")
    return bench_dir


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory) -> Path:
    torch.set_num_threads(2)
    return make_copy(tmp_path_factory.mktemp("bench"))
