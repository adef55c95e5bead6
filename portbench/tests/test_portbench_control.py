"""The control (the reference in the program's place with TF32 operands)
and each planted fault fail the committed limits; the reference in the
program's own precision passes them.  At tiny sizes on the CPU; the same
readings at the cells' sizes come from ``readings.py`` on the card."""
import math

import pytest
import torch

from conftest import TINY, tiny_name
from portbench import readings, run


def _fails(numbers, limits):
    return [n for n, lim in limits.items()
            if not math.isfinite(numbers[n]) or numbers[n] > lim]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_and_faults_fail(bench_copy, cell):
    out = readings.control_readings(tiny_name(cell), 31337,
                                    torch.device("cpu"),
                                    bench_dir=bench_copy,
                                    root=bench_copy.parent)
    limits = run.cell_spec(cell)["limits"]
    assert not _fails(out["float32"], limits), out["float32"]
    for who in ("tf32", "state_unchanged", "half_batch", "answer_altered",
                "answers_swapped"):
        assert _fails(out[who], limits), (who, out[who])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-12])
    y = torch.tensor([1.0, 1.0 + 2**-10, 1.0, -3.0])
    assert torch.equal(readings.reference.to_tf32(x), y)
