"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything of a cell is found by name: its entry in ``BENCHMARK.json`` at
the checkout's root names a configuration (``configs/<config>.json``) and
a traffic mix (``traffic/<traffic>.json``); the traffic names its driver
(``drivers/<driver>.py``: set-up, the measured window, the comparison's
numbers); each metric is read by ``metrics/<metric>.py``; each number the
comparison yields is held to its limit in ``limits/<workload>.json``.
A new cell, driver or metric is new files and entries: nothing here
changes.

The run uses the CUDA card and exits with an error, printing no result,
where there is none.  The last line on standard output is the result, one
JSON object; the last lines on standard error are the numbers compared,
each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

#: top-level modules no run may load: JAX and the JAX package the port
#: mirrors (``repro_torch`` is another name, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_file(path: Path, name: str):
    """A module from its file, by path: metric names may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT, bench_dir: Path = HERE
              ) -> dict:
    """BENCHMARK.json, and the cell's entry, configuration, traffic and
    limits."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    limits = bench_dir / "limits" / f"{workload}.json"
    return {"bench": bench, "cell": cell,
            "config": read_json(bench_dir / "configs"
                                / f"{cell['config']}.json"),
            "traffic": read_json(bench_dir / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": read_json(limits) if limits.exists() else {}}


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: end-to-end ones untraced,
    per-layer ones traced.  A metric with a ``workloads`` list is reported
    in those cells; a per-layer one without it wherever its ``moves``
    metric is."""
    def here(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if here(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def compare(numbers: Dict[str, float], limits: Dict[str, float]):
    """(every number within its limit, {name: {"value", "limit"}}).  A
    number without a limit, or a limit without a number, fails."""
    out, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        good = _finite(value) and _finite(limit) and value <= limit
        ok = ok and good
        out[name] = {"value": value if _finite(value) else str(value),
                     "limit": limit if _finite(limit) else str(limit)}
    return ok and bool(limits), out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: Path = ROOT, bench_dir: Path = HERE,
             t_start: Optional[float] = None,
             log: Callable[[str], None] = log) -> dict:
    """One run on ``device``: the result object (the check's numbers last)."""
    import torch

    spec = cell_spec(workload, root, bench_dir)
    name = spec["traffic"]["driver"]
    driver = load_file(bench_dir / "drivers" / f"{name}.py",
                       f"portbench_driver_{name}")
    obs = driver.run({"config": spec["config"], "traffic": spec["traffic"],
                      "seed": int(seed), "seconds": float(seconds),
                      "trace": bool(trace), "device": torch.device(device),
                      "log": log, "t_start": (T_START if t_start is None
                                              else t_start)})
    ok, checked = compare(obs["numbers"], spec["limits"])
    correct = ok and obs["failed"] == 0 and obs["compared"] > 0
    metrics = {}
    for m in cell_metrics(spec["bench"], workload, trace):
        reader = load_file(bench_dir / "metrics" / f"{m['name']}.py",
                           f"portbench_metric_{len(metrics)}")
        value = reader.read(obs)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {"correct": bool(correct), "attempted": obs["attempted"],
              "failed": obs["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else dev.type),
                         "count": 1,
                         "memory_peak_bytes": obs["memory_peak_bytes"]}}
    tr = obs.get("trace")
    if trace and tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        top = sorted(tr["kernels"], key=lambda r: -r[2])[:10]
        result["breakdown"] = {
            "device_ops": [[name[:160], secs] for name, _, secs in top],
            "idle_gaps": [[name[:160], secs]
                          for name, secs in tr["idle_gaps"][:10]]}
    log(f"[check] {obs['compared']} answers compared, {obs['failed']} "
        f"queries failed")
    result["check"] = checked
    return result


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one client's load from one process with few threads
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every kernel and compiler cache at a fixed path inside the checkout
    cache = ROOT / "build" / "portbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    import torch
    chips = int(cell_spec(args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark measures the port alone")
        return 3
    for name, row in result["check"].items():
        log(f"[check] {name} {row['value']} <= {row['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
