"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the reference imports nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, REPO, tiny_name

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _run_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_file_imports_jax_or_repro():
    for path in _run_files():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_nothing_reads_the_jax_benchmarks():
    for path in _run_files():
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py",):
        tops = {n.split(".")[0] for n in _imports(BENCH / name)}
        assert tops <= {"__future__", "contextlib", "typing", "numpy",
                        "torch"}, tops


def test_a_run_loads_no_forbidden_module(bench_copy):
    cell = tiny_name("sift1m-flat.probe8-q256-k10")
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(bench_copy.parent)!r}, {str(REPO / 'src')!r}]\n"
        "torch.set_num_threads(2)\n"
        "from portbench import run\n"
        "from pathlib import Path\n"
        f"res = run.run_cell({cell!r}, 5, 0.3, False, 'cpu', "
        f"root=Path({str(bench_copy.parent)!r}), "
        f"bench_dir=Path({str(bench_copy)!r}))\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    sys.path.insert(0, str(BENCH.parent))
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", json)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", json)
    assert "repro" in run.forbidden_modules()
