"""The generators repeat from a seed, and every seed gives the same shapes."""
import numpy as np
import torch

from portbench import data

SPEC = {"n": 2000, "dim": 16, "rows_per_cluster": 2.3, "center_scale": 1.0,
        "noise": 0.058, "unit_centers": True, "unit_rows": True}
SEED = 2**31 + 12345          # larger than 32 signed bits hold


def test_vectors_repeat_from_the_seed():
    a = data.make_vectors(SPEC, 100, SEED, torch.device("cpu"))
    b = data.make_vectors(SPEC, 100, SEED, torch.device("cpu"))
    c = data.make_vectors(SPEC, 100, SEED + 1, torch.device("cpu"))
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (2000, 16) and a[1].shape == (100, 16)
    assert a[0].dtype == np.float32
    assert np.allclose(np.linalg.norm(a[0], axis=1), 1.0, atol=1e-5)


def test_queries_are_fresh_draws_not_rows():
    rows, queries = data.make_vectors(dict(SPEC, unit_rows=False), 200,
                                      7, torch.device("cpu"))
    d = ((queries[:, None, :] - rows[None]) ** 2).sum(-1)
    assert d.min() > 0


def test_batch_draws_repeat_and_are_distinct():
    a, b = data.batch_draws(SEED, 300, 32), data.batch_draws(SEED, 300, 32)
    for _ in range(20):
        x, y = next(a), next(b)
        assert np.array_equal(x, y)
        assert len(set(x.tolist())) == 32 and x.max() < 300
