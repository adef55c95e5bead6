"""On the card: the command prints one result line with the contract's
keys and exits 0, for a tiny copy of every cell, untraced and traced."""
import json
import subprocess
import sys

import pytest

from conftest import TINY, tiny_name


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark runs on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_command_on_the_card(card, bench_copy, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", tiny_name(cell),
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", str(trace)],
        cwd=bench_copy.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
        assert "device_idle_share" in res["metrics"]
