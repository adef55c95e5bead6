"""A new configuration, traffic mix, driver and per-layer metric are new
files and BENCHMARK.json entries: the harness finds them by name."""
import json

from conftest import tiny_name
from portbench import run

DRIVER = '''
def run(ctx):
    return {"attempted": 8, "failed": 0, "setup_s": 0.5, "window_s": 1.0,
            "batches": 2, "queries": 8, "latencies_s": [0.5, 0.5],
            "peak_window_bytes": 0, "memory_peak_bytes": 0, "scan_rows": 16,
            "work": {"least_s": 0.1}, "trace": None,
            "numbers": {"answers_off": ctx["config"]["offset"]},
            "compared": 8}
'''

METRIC = '''
def read(obs):
    return obs["queries"] / obs["batches"]
'''


def test_new_files_are_found_by_name(bench_copy):
    d = bench_copy
    (d / "configs" / "throwaway.json").write_text(json.dumps({"offset": 0}))
    (d / "traffic" / "echo.json").write_text(json.dumps({"driver": "echo"}))
    (d / "drivers" / "echo.py").write_text(DRIVER)
    (d / "metrics" / "queries_per_batch.py").write_text(METRIC)
    (d / "limits" / "throwaway.echo.json").write_text(
        json.dumps({"answers_off": 0}))
    path = d.parent / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    spec["workloads"].append({"name": "throwaway.echo", "config": "throwaway",
                              "traffic": "echo", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "queries_per_batch", "unit": "queries",
                              "better": "higher", "source": "host_clock",
                              "layer": "vector index", "moves": "knn_qps",
                              "workloads": ["throwaway.echo"]})
    spec["end_to_end"][0]["workloads"].append("throwaway.echo")
    path.write_text(json.dumps(spec))
    try:
        res = run.run_cell("throwaway.echo", 1, 1.0, True, "cpu",
                           root=d.parent, bench_dir=d)
        assert res["correct"]
        assert res["metrics"] == {"queries_per_batch": {"value": 4.0,
                                                        "unit": "queries"}}
        res = run.run_cell("throwaway.echo", 1, 1.0, False, "cpu",
                           root=d.parent, bench_dir=d)
        assert set(res["metrics"]) == {"knn_qps", "setup_s"}
        assert res["metrics"]["knn_qps"]["value"] == 8.0
    finally:
        spec["workloads"].pop()
        spec["per_layer"].pop()
        spec["end_to_end"][0]["workloads"].remove("throwaway.echo")
        path.write_text(json.dumps(spec))


def test_a_number_without_a_limit_fails():
    ok, rows = run.compare({"a": 0.0, "b": 1.0}, {"a": 1.0})
    assert not ok and rows["b"]["limit"] == "None"
    ok, _ = run.compare({"a": 0.0}, {"a": 1.0, "b": 1.0})
    assert not ok
    ok, _ = run.compare({"a": float("inf")}, {"a": 1.0})
    assert not ok
    assert run.compare({"a": 1.0}, {"a": 1.0})[0]


def test_metrics_of_a_cell():
    spec = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = "sift1m-flat.probe8-q256-k10"
    names = [m["name"] for m in run.cell_metrics(spec, cell, True)]
    assert "ivf_scan_roofline_share" not in names
    assert "roofline_share" in names
    names = [m["name"] for m in run.cell_metrics(
        spec, "sift1m-flat.exact-q256-k10", True)]
    assert "ivf_scan_roofline_share" in names
    e2e = [m["name"] for m in run.cell_metrics(spec, cell, False)]
    assert e2e == ["knn_qps", "batch_p95_ms", "device_peak_gb", "setup_s"]
    assert tiny_name(cell)
