"""A run whose timed path is broken underneath comes out not correct, once
for each fault a kNN cell can have; the same run unbroken is correct."""
import dataclasses

import numpy as np
import pytest

from conftest import TINY, tiny_name
from portbench import run
from repro_torch.core.vector_index import IVFIndex

_search = IVFIndex.search_many
_build = IVFIndex.build


def half_batch(self, queries, k, nprobe=None, **kw):
    v, i = _search(self, queries, k, nprobe, **kw)
    v[len(v) // 2:], i[len(i) // 2:] = -np.inf, -1
    return v, i


def answer_altered(self, queries, k, nprobe=None, **kw):
    v, i = _search(self, queries, k, nprobe, **kw)
    i[0, 0] = (i[0, 0] + len(self.ids) // 2) % len(self.ids)
    return v, i


def answers_swapped(self, queries, k, nprobe=None, **kw):
    v, i = _search(self, queries, k, nprobe, **kw)
    v[:, [0, 1]], i[:, [0, 1]] = v[:, [1, 0]], i[:, [1, 0]]
    return v, i


def state_unchanged(vectors, ids=None, cfg=None, **kw):
    return _build(vectors, ids, dataclasses.replace(cfg, kmeans_iters=0),
                  **kw)


FAULTS = {"half_batch": ("search_many", half_batch),
          "answer_altered": ("search_many", answer_altered),
          "answers_swapped": ("search_many", answers_swapped),
          "state_unchanged": ("build", staticmethod(state_unchanged))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_caught(bench_copy, monkeypatch, cell, fault):
    attr, fn = FAULTS[fault]
    monkeypatch.setattr(IVFIndex, attr, fn)
    res = run.run_cell(tiny_name(cell), 424242, 0.3, False, "cpu",
                       root=bench_copy.parent, bench_dir=bench_copy)
    assert not res["correct"], res["check"]
    over = [n for n, r in res["check"].items()
            if not isinstance(r["value"], (int, float))
            or r["value"] > r["limit"]]
    assert over, res["check"]
