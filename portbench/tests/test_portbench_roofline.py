"""The work arithmetic gives the FLOPs and bytes of the three cells."""
import numpy as np
import pytest

from portbench import roofline


def _one_batch(q, m, sizes, probed, d, k):
    probe = np.zeros((q, m), bool)
    probe[:, :probed] = True
    return roofline.knn_work([np.arange(q)], probe, np.asarray(sizes), d, k)


def test_join_cell_every_bucket():
    # snb100-faces.join-q1024-k100: 448,626 rows in 4 buckets, all probed
    w = _one_batch(1024, 4, [112156, 112157, 112156, 112157], 4, 128, 100)
    assert w["flops"] == 2 * 128 * 448626 * 1024            # 117.6 GFLOP
    assert w["bytes"] == 4 * 128 * (448626 + 1024) + 8 * 100 * 1024
    assert w["least_s"] == pytest.approx(w["flops"] / 67e12)  # 1.755 ms


def test_exact_cell_whole_table():
    w = _one_batch(256, 10, [100000] * 10, 10, 128, 10)
    assert w["flops"] == 2 * 128 * 1_000_000 * 256          # 65.5 GFLOP
    assert w["least_s"] == pytest.approx(65.536e9 / 67e12)


def test_probe8_cell_counts_probed_rows_and_the_union():
    probe = np.zeros((256, 10), bool)
    probe[:128, :8] = True                  # half the batch: buckets 0-7
    probe[128:, 2:] = True                  # the other half: buckets 2-9
    w = roofline.knn_work([np.arange(256)], probe,
                          np.full(10, 100000), 128, 10)
    assert w["flops"] == 2 * 128 * 800000 * 256             # 52.4 GFLOP
    assert w["bytes"] == 4 * 128 * (1_000_000 + 256) + 8 * 10 * 256
    assert w["least_s"] == pytest.approx(w["flops"] / 67e12)


def test_memory_bound_batch():
    assert roofline.least_s(1.0, 3.35e12) == pytest.approx(1.0)
