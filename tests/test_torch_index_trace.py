"""Spans and counters inside ``IVFIndex.search_many``, on the CPU.

One small seeded index per scan path (one query, probe-signature groups,
the masked dense scan, staged ADC and the fused ADC scan, the PQ paths
with and without residual codes): the ``ivf.*`` span tree a ``Trace``
receives, the same names as profiler ranges inside the caller's range,
nothing opened or allocated with neither, answers bit for bit the same in
all three, and the ``vector_index`` counters advancing by the probe
signatures and by the bytes of every array the search copies, the groups
gathered in ``np.unique``'s signature order.  Last, the benchmark's
readers of these spans and counters, loaded by path.
"""
import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs.pandadb import VectorIndexConfig
from repro_torch.core import vector_index as pvi
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import NULL_SPAN, Trace, phases, span

# the suite runs in several workers at once: one intra-op thread here
torch.set_num_threads(1)

D, M, N, K, RERANK = 16, 8, 800, 5, 3
PQ_M, KSUB = 4, 16
ROOT = Path(__file__).resolve().parents[1]

#: case -> (pq codes, residual, mode, queries: "one" | "few" | "many",
#: nprobe, the path search_many must take)
CASES = {
    "one": (False, False, "float", "one", 2, "one"),
    "grouped": (False, False, "float", "few", 2, "grouped"),
    "exact": (False, False, "float", "many", M, "grouped"),
    "dense": (False, False, "float", "many", 4, "dense"),
    "adc": (True, False, "adc", "few", 2, "adc"),
    "adc_residual": (True, True, "adc", "many", 2, "adc"),
    "fused": (True, False, "fused", "many", 2, "fused"),
    "fused_residual": (True, True, "fused", "few", 2, "fused"),
}

#: the spans each batch opens under ``ivf.search``; ``*`` repeats once per
#: probe signature
TREES = {
    "one": ["ivf.search_one"],
    "grouped": ["ivf.probe", "ivf.group",
                "*", "ivf.gather", "ivf.scan", "ivf.fetch", "ivf.map"],
    "dense": ["ivf.probe", "ivf.group", "ivf.gather", "ivf.scan",
              "ivf.fetch", "ivf.map"],
    "adc": ["ivf.probe", "ivf.group", "ivf.luts",
            "*", "ivf.gather", "ivf.scan", "ivf.fetch", "ivf.rerank",
            "ivf.map"],
    "fused": ["ivf.probe", "ivf.luts", "ivf.scan", "ivf.fetch", "ivf.rerank",
              "ivf.map"],
}


def _index(case):
    pq, residual, mode, which, nprobe, _ = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    cfg = VectorIndexConfig(dim=D, metric="l2", min_buckets=M,
                            vectors_per_bucket=10 ** 6, nprobe=nprobe,
                            pq_m=PQ_M if pq else 0,
                            pq_bits=int(np.log2(KSUB)), pq_residual=residual,
                            rerank_mult=RERANK, pending_compact_min=10 ** 6)
    state = {"vectors": rng.normal(size=(N, D)).astype(np.float32),
             "centroids": rng.normal(size=(M, D)).astype(np.float32),
             "bucket_of": np.sort(rng.integers(0, M, N)).astype(np.int64),
             "ids": rng.permutation(3 * N)[:N].astype(np.int64)}
    if pq:
        state["codebooks"] = rng.normal(
            size=(PQ_M, KSUB, D // PQ_M)).astype(np.float32)
        state["codes"] = rng.integers(0, KSUB, (N, PQ_M)).astype(np.uint8)
        if residual:
            state["code_bias"] = rng.normal(size=N).astype(np.float32)
    index = pvi.IVFIndex.from_state(state, cfg, device="cpu")
    if which == "one":
        queries = rng.normal(size=(1, D))
    elif which == "few":    # three distinct queries: few signatures
        queries = np.repeat(rng.normal(size=(3, D)), 5, axis=0)
    else:
        queries = rng.normal(size=(48, D))
    return index, queries.astype(np.float32), mode, nprobe


def _probe(index, queries, nprobe):
    """The batched probe, as the reference would: sorted bucket sets."""
    q = torch.from_numpy(queries)
    s = pvi.pairwise_scores(q, torch.from_numpy(index.centroids), "l2")
    _, probe = pvi.stable_topk(s, nprobe)
    return np.sort(probe.numpy(), axis=1)


def _search(index, queries, mode, nprobe, trace=None):
    return index.search_many(queries, K, nprobe, mode=mode, trace=trace)


def _expected(case, index, queries, nprobe):
    """(signatures, h2d bytes, d2h bytes) of one batch, from the shapes."""
    pq, residual, _, _, _, path = CASES[case]
    qn = queries.shape[0]
    if path == "one":
        return 1, 0, 0
    probe = _probe(index, queries, nprobe)
    sigs, inverse = np.unique(probe, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    h2d = qn * D * 4                           # the queries
    d2h = qn * nprobe * 8                      # the probe, int64
    if residual:
        d2h += qn * M * 4                      # centroid scores for cterm
        h2d += qn * M * 4                      # cterm back up
    if pq:
        h2d += qn * PQ_M * KSUB * 4            # LUTs
    if path == "fused":
        kprime = min(N, RERANK * K)
        return None, h2d + qn * M, d2h + qn * kprime * 8
    if path == "dense":
        return len(sigs), h2d + qn * M, d2h + qn * K * (4 + 8)
    for g, sig in enumerate(sigs):
        nq = int((inverse == g).sum())
        rows = int(np.isin(index.bucket_of, sig).sum())
        if len(sig) < M:
            h2d += rows * 8                    # the gathered rows' index
        if path == "adc":
            h2d += nq * 8                      # qsel
            d2h += nq * min(rows, RERANK * K) * 4
        else:
            if nq < qn:
                h2d += nq * 8                  # qsel
            d2h += nq * K * (4 + 8)            # scores, int64 ids
    return len(sigs), h2d, d2h


def _counters():
    return dict(pvi.METRICS.snapshot()["counters"])


def _tree(case, n_sigs):
    path = CASES[case][5]
    tree = TREES["grouped" if path == "grouped" else path]
    if "*" not in tree:
        return tree
    i = tree.index("*")
    return tree[:i] + tree[i + 1:] * n_sigs


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_as_the_table_says(case):
    index, queries, mode, nprobe = _index(case)
    path = CASES[case][5]
    tr = Trace("caller")
    _search(index, queries, mode, nprobe, tr)
    tr.finish()
    assert tr.well_nested()
    (search,) = tr.root.children
    assert search.name == "ivf.search"
    n_sigs, _, _ = _expected(case, index, queries, nprobe)
    assert search.attrs == {"q": len(queries), "k": K, "nprobe": nprobe,
                            "path": path, "signatures": n_sigs}
    assert [c.name for c in search.children] == _tree(case, n_sigs or 1)
    assert all(not c.children for c in search.children)
    for c in search.children:
        if c.name == "ivf.group":
            assert c.attrs == {"signatures": n_sigs, "path": path}
        if c.name in ("ivf.gather", "ivf.scan"):
            assert c.attrs["rows"] > 0
        if c.name == "ivf.fetch":
            assert c.attrs["bytes"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_counters_advance_by_signatures_and_bytes(case):
    index, queries, mode, nprobe = _index(case)
    n_sigs, h2d, d2h = _expected(case, index, queries, nprobe)
    before = _counters()
    _search(index, queries, mode, nprobe)
    after = _counters()
    delta = {name: after[name] - before.get(name, 0) for name in after}
    path = CASES[case][5]
    assert delta == {"ivf.batches": 1, "ivf.queries": len(queries),
                     "ivf.signatures": n_sigs or 0,
                     "ivf.h2d_bytes": h2d, "ivf.d2h_bytes": d2h,
                     **{f"ivf.path.{p}": int(p == path) for p in pvi.PATHS}}


def _gathers(trace):
    """(rows, queries) of each group's ``ivf.gather`` and ``ivf.scan``, in
    the order the spans were opened."""
    spans = [s for s in trace.spans() if s.name in ("ivf.gather", "ivf.scan")]
    return [(g.attrs["rows"], s.attrs["q"])
            for g, s in zip(spans[::2], spans[1::2])]


@pytest.mark.parametrize("case", ["grouped", "adc", "dense"])
def test_groups_scanned_in_np_unique_order(case, monkeypatch):
    """The groups are gathered in the order of ``np.unique(probe, axis=0)``'s
    signatures, each with its queries: the order the grouping keeps.  The
    dense case takes the masked scan, one gather of every row; its
    scattered signatures are then run through the grouped scan."""
    index, queries, mode, nprobe = _index(case)
    probe = _probe(index, queries, nprobe)
    sigs, inverse = np.unique(probe, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    want = [(int(np.isin(index.bucket_of, sig).sum()),
             int((inverse == g).sum())) for g, sig in enumerate(sigs)]
    assert len(sigs) > 1
    gathered = []
    for name in ("_gather_buckets_dev", "_gather_codes_dev"):
        def spy(buckets, _gather=getattr(index, name)):
            gathered.append(np.asarray(buckets).tolist())
            return _gather(buckets)
        monkeypatch.setattr(index, name, spy)
    tr = Trace()
    _search(index, queries, mode, nprobe, tr)
    (group,) = tr.find("ivf.group")
    assert group.attrs["signatures"] == len(sigs)
    if CASES[case][5] != "dense":
        assert gathered == sigs.tolist()
        assert _gathers(tr) == want
        return
    assert gathered == [list(range(M))]
    assert _gathers(tr) == [(N, len(queries))]
    gathered.clear()
    tr = Trace()
    out_v = np.full((len(queries), K), -np.inf, np.float32)
    out_i = np.full((len(queries), K), -1, np.int64)
    with phases(tr, "ivf.search") as ph:
        index._scan_groups(torch.from_numpy(queries),
                           *pvi._group_signatures(probe), K, out_v, out_i,
                           ph)
    assert gathered == sigs.tolist()
    assert _gathers(tr) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiler_ranges_inside_the_callers_range(case):
    index, queries, mode, nprobe = _index(case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            _search(index, queries, mode, nprobe)
    events = prof.events()
    (caller,) = [e for e in events if e.name == "caller"]
    ivf = [e for e in events if e.name.startswith("ivf.")]
    n_sigs, _, _ = _expected(case, index, queries, nprobe)
    assert sorted(e.name for e in ivf) == sorted(
        ["ivf.search"] + _tree(case, n_sigs or 1))
    for e in ivf:
        assert caller.time_range.start <= e.time_range.start
        assert e.time_range.end <= caller.time_range.end


@pytest.mark.parametrize("case", sorted(CASES))
def test_answers_identical_off_traced_and_profiled(case):
    index, queries, mode, nprobe = _index(case)
    off = _search(index, queries, mode, nprobe)
    traced = _search(index, queries, mode, nprobe, Trace())
    with profile(activities=[ProfilerActivity.CPU]):
        tr = Trace()
        both = _search(index, queries, mode, nprobe, tr)
    assert [s.name for s in tr.spans()][1] == "ivf.search"
    for got in (traced, both):
        for a, b in zip(off, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["one", "grouped", "dense", "adc", "fused"])
def test_off_opens_no_range_and_allocates_no_span(case, monkeypatch):
    index, queries, mode, nprobe = _index(case)

    def refuse(*a, **kw):
        raise AssertionError("opened with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(obs_trace.Span, "__init__", refuse)
    monkeypatch.setattr(obs_trace.Phases, "__init__", refuse)
    given = []

    def spy(*a, **kw):
        given.append(phases(*a, **kw))
        return given[-1]

    monkeypatch.setattr(pvi, "phases", spy)
    _search(index, queries, mode, nprobe)
    assert given == [obs_trace._NULL_PHASES]


def test_span_helper_three_ways():
    assert span(None, "x", a=1) is NULL_SPAN
    with span(None, "x") as sp:
        assert sp is NULL_SPAN and sp.set(a=1) is NULL_SPAN
    assert phases(None, "x", a=1) is obs_trace._NULL_PHASES
    with phases(None, "x") as ph:
        assert ph is None
    tr = Trace()
    with pytest.raises(KeyError):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span(tr, "outer", a=1) as sp:
                sp.set(b=2)
                with span(tr, "inner"):
                    raise KeyError("stamped")
    tr.finish()
    outer, inner = tr.spans()[1:]
    assert outer.attrs == {"a": 1, "b": 2, "error": "KeyError"}
    assert inner.parent is outer and inner.attrs == {"error": "KeyError"}
    assert tr.well_nested()
    names = [e.name for e in prof.events()]
    assert names.count("outer") == 1 and names.count("inner") == 1


@pytest.mark.parametrize("profiled", [False, True])
def test_phases_follow_one_another(profiled):
    """Each ``next`` ends the running step; an escaping error is stamped on
    the running step and the span, and the profiler's ranges nest."""
    tr = Trace()
    recording = (profile(activities=[ProfilerActivity.CPU]) if profiled
                 else contextlib.nullcontext())
    with pytest.raises(KeyError), recording as prof:
        with phases(tr, "outer", a=1) as ph:
            ph.next("one", b=2)
            ph.set(c=3)
            ph.next("two")
            ph.span.set(d=4)
            raise KeyError("stamped")
    tr.finish()
    outer, one, two = tr.spans()[1:]
    assert [one.parent, two.parent] == [outer, outer]
    assert one.t1 <= two.t0 and tr.well_nested()
    assert outer.attrs == {"a": 1, "d": 4, "error": "KeyError"}
    assert one.attrs == {"b": 2, "c": 3}
    assert two.attrs == {"error": "KeyError"}
    if profiled:
        ev = {e.name: e for e in prof.events()}
        assert ev["outer"].time_range.start <= ev["one"].time_range.start
        assert ev["one"].time_range.end <= ev["two"].time_range.start
        assert ev["two"].time_range.end <= ev["outer"].time_range.end


# --- the benchmark's readers --------------------------------------------


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _obs(kernels=(("ivf_score", 4, 0.5),)):
    return {"trace": {"kernels": list(kernels), "busy_s": 1.5,
                      "window_s": 2.5, "batches": 4, "least_s": 0.1,
                      "idle_gaps": [("ivf.map", 0.4), ("ivf.group", 0.1),
                                    ("portbench.search_many", 0.3),
                                    ("aten::sort", 0.2)]}}


def _snapshot(counters):
    return lambda: [{"namespace": "serving", "counters": {"x": 1}},
                    {"namespace": "vector_index", "counters": counters}]


COUNTS = {"ivf.batches": 8, "ivf.queries": 2048, "ivf.signatures": 20,
          "ivf.h2d_bytes": 1_048_576, "ivf.d2h_bytes": 397_312}


@pytest.mark.parametrize("name, want", [
    ("index_host_idle_share", 100.0 * 0.5 / 2.5),
    ("probe_signatures_per_batch", 20 / 8),
    ("host_copy_bytes_per_query", (1_048_576 + 397_312) / 2048),
])
def test_readers(name, want, monkeypatch):
    mod = _reader(name)
    monkeypatch.setattr(mod, "global_snapshot", _snapshot(COUNTS))
    assert mod.read(_obs()) == pytest.approx(want, rel=1e-12)
    # no device operation (a CPU run), or no trace: nothing to read
    assert mod.read(_obs(kernels=())) is None
    assert mod.read({"trace": None}) is None
    # a program without the index's counters (the parent of this change)
    monkeypatch.setattr(mod, "global_snapshot",
                        lambda: [{"namespace": "serving", "counters": {}}])
    assert mod.read(_obs()) is None


def test_counter_readers_read_the_live_registry():
    index, queries, mode, nprobe = _index("dense")
    _search(index, queries, mode, nprobe)
    c = _counters()
    assert _reader("probe_signatures_per_batch").read(_obs()) == \
        c["ivf.signatures"] / c["ivf.batches"]
    assert _reader("host_copy_bytes_per_query").read(_obs()) == \
        (c["ivf.h2d_bytes"] + c["ivf.d2h_bytes"]) / c["ivf.queries"]
