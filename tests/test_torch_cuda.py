"""The port's CUDA kernels and its device path on the card, against the
plain versions and the CPU run of the same port.

Every test here needs a CUDA card and ``nvcc`` and skips without one.  The
file imports torch and the port only, so it also runs on a host without
JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Integer-valued inputs make every float32 sum exact, so the kernels must
agree with the plain versions bitwise, ties included; PQ sums run in the
plain version's order and agree bitwise on float inputs too.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ivf_scan import ops as ivf_ops
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
from repro_torch.kernels.pq_scan import ops as pq_ops
from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref
from repro_torch.kernels.topk_merge import ops as merge_ops
from repro_torch.kernels.topk_merge.ops import merge_topk_dev
from repro_torch.kernels.topk_merge.ref import merge_topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the CUDA kernels cannot "
                    "run on the CPU")
    return torch.device("cuda")


def _int(rng, *shape, lo=-3, hi=4):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def _one_hot(rng, rows, d):
    x = np.zeros((rows, d), np.float32)
    x[np.arange(rows), rng.integers(0, d, rows)] = rng.integers(1, 6, rows)
    return torch.from_numpy(x)


@pytest.mark.parametrize("qn,n,d,k,metric,n_valid", [
    (37, 5000, 128, 10, "l2", 4999), (8, 257, 16, 300, "ip", 257),
    (300, 3000, 64, 64, "l2", 2900), (5, 1000, 32, 256, "cosine", 1000),
    (9, 700, 128, 700, "l2", 700),
])
def test_ivf_kernel_matches_plain(cuda, qn, n, d, k, metric, n_valid):
    rng = np.random.default_rng(n + k)
    q, c = _int(rng, qn, d).to(cuda), _int(rng, n, d).to(cuda)
    if metric == "cosine":
        # one nonzero per row: normalising is exact, so are the scores
        q, c = (_one_hot(rng, rows, d).to(cuda) for rows in (qn, n))
    before = ivf_ops.launches.n
    kv, ki = ivf_scan_topk(q, c, k, metric=metric, n_valid=n_valid)
    pv, pi = ivf_scan_topk_ref(q, c, min(k, n_valid), metric=metric,
                               n_valid=n_valid)
    torch.cuda.synchronize()
    assert ivf_ops.launches.n == before + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def test_ivf_kernel_duplicate_rows_tie_to_lower_row(cuda):
    rng = np.random.default_rng(1)
    base = _int(rng, 300, 32)
    c = torch.cat([base, base, base]).to(cuda)
    q = _int(rng, 11, 32).to(cuda)
    kv, ki = ivf_scan_topk(q, c, 40)
    pv, pi = ivf_scan_topk_ref(q, c, 40)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


MASKED_CASES = ["l2", "ip", "cosine", "q_past_128", "starved_query",
                "fewer_rows_than_k", "ties_across_mask_edge",
                "unsorted_buckets", "query_chunks"]


def masked_case(case):
    """(q, corpus, row_bucket int32, probe_mask uint8, k, metric) of one
    case of the index's dense probe scan, on the CPU; integer-valued (one
    nonzero a row for cosine), so every score is exact."""
    rng = np.random.default_rng(sum(map(ord, case)))
    qn, n, d, m, k, metric = {
        "l2": (37, 5000, 128, 10, 10, "l2"),             # ragged last tile
        "ip": (9, 777, 16, 4, 20, "ip"),
        "cosine": (5, 1000, 32, 6, 50, "cosine"),
        "q_past_128": (300, 3001, 64, 10, 64, "l2"),     # 3 query blocks
        "starved_query": (11, 700, 32, 5, 10, "l2"),
        "fewer_rows_than_k": (6, 900, 16, 8, 40, "l2"),
        "ties_across_mask_edge": (13, 900, 32, 3, 60, "l2"),
        "unsorted_buckets": (20, 1200, 32, 7, 30, "ip"),
        "query_chunks": (30, 2001, 32, 5, 300, "l2"),
    }[case]
    q, c = _int(rng, qn, d), _int(rng, n, d)
    if metric == "cosine":
        q, c = _one_hot(rng, qn, d), _one_hot(rng, n, d)
    rb = np.sort(rng.integers(0, m, n))
    pm = rng.random((qn, m)) < 0.7
    if case == "starved_query":
        pm[0] = False                           # every bucket masked
    if case == "fewer_rows_than_k":
        rb = np.sort(rng.integers(0, m - 1, n))
        rb[-5:] = m - 1                         # the last bucket: 5 rows
        pm[1] = np.arange(m) == m - 1           # query 1 probes only it
    if case == "ties_across_mask_edge":
        c = torch.cat([c[:n // 3]] * 3)         # row r ties r +- 300, 600
        rb = np.repeat(np.arange(m), n // m)    # each copy its own bucket
    if case == "unsorted_buckets":
        rb[-200:] = rng.integers(0, m, 200)     # pending rows after the table
    return (q, c, torch.from_numpy(rb.astype(np.int32)),
            torch.from_numpy(pm.astype(np.uint8)), k, metric)


def stable_sort_masked(q, c, row_bucket, probe_mask, k, metric):
    """The dense probe scan as one formula: every score, the non-probed
    rows set to -inf by ``where``, a full stable sort -> (vals, rows
    int32)."""
    from repro_torch.kernels.ivf_scan.ref import scores_ref
    s = torch.where(probe_mask.bool()[:, row_bucket.long()],
                    scores_ref(q, c, metric), -torch.inf)
    vals, rows = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], rows[:, :k].to(torch.int32)


@pytest.mark.parametrize("case", MASKED_CASES)
def test_ivf_masked_kernel_matches_plain(cuda, monkeypatch, case):
    """The masked scoring kernel, radix select and the survivors' sort
    against the plain version with the same mask and against the full
    stable sort of the ``where``-masked scores: values and int32 rows
    equal, -inf ties to the lower row, and a query keeps finite values
    only on its probed rows (none: every id -1 once mapped)."""
    q, c, rb, pm, k, metric = (t.to(cuda) if torch.is_tensor(t) else t
                               for t in masked_case(case))
    chunks = 1
    if case == "query_chunks":
        ld = -(-c.shape[0] // 4) * 4
        monkeypatch.setattr(ivf_ops, "SCRATCH_BYTES", 4 * ld * 7)
        chunks = 5                              # ceil(30 / 7)
    mask = pm.bool() if case == "ip" else pm    # bool is taken as uint8
    before = ivf_ops.launches.n
    kv, ki = ivf_scan_topk(q, c, k, metric, row_bucket=rb, probe_mask=mask)
    pv, pi = ivf_scan_topk_ref(q, c, k, metric, row_bucket=rb, probe_mask=pm)
    sv, si = stable_sort_masked(q, c, rb, pm, k, metric)
    torch.cuda.synchronize()
    assert ivf_ops.launches.n == before + chunks
    assert ki.dtype == torch.int32
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ki, si) and torch.equal(kv, sv)
    probed = pm.bool()[:, rb.long()].sum(1).clamp(max=k)
    assert torch.equal(torch.isfinite(kv).sum(1), probed)
    if case == "starved_query":
        assert bool((torch.where(torch.isfinite(kv), ki, -1)[0] == -1).all())


@pytest.mark.parametrize("k", [10, 256, 800])
def test_pq_kernels_match_plain(cuda, k):
    rng = np.random.default_rng(k)
    qn, n, mb = 19, 6000, 9
    luts = torch.randn(qn, 16, 256, generator=torch.Generator().manual_seed(k))
    luts = luts.to(cuda)
    codes = torch.from_numpy(rng.integers(0, 256, (n, 16)).astype(
        np.uint8)).to(cuda)
    before = (pq_ops.launches.n, pq_ops.ext_launches.n)
    kv, ki = pq_adc_topk(luts, codes, k, n_valid=n - 3)
    pv, pi = pq_adc_topk_ref(luts, codes, k, n_valid=n - 3)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    rb = torch.from_numpy(rng.integers(0, mb, n).astype(np.int32)).to(cuda)
    pm = torch.from_numpy(rng.random((qn, mb)) < 0.3)
    pm[0] = False                                  # a starved query
    ext = dict(bias=torch.randn(n, device=cuda), row_bucket=rb,
               cscores=torch.randn(qn, mb, device=cuda),
               probe_mask=pm.to(cuda))
    kv, ki = pq_adc_topk(luts, codes, k, **ext)
    pv, pi = pq_adc_topk_ref(luts, codes, k, **ext)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert bool((ki[0] == -1).all())
    assert (pq_ops.launches.n, pq_ops.ext_launches.n) == \
        (before[0] + 1, before[1] + 1)


def _windows(rng, p, qn, kk, pad=0, ties=False):
    """Shard windows as a scatter-gather stacks them: rows sorted, (-inf,
    -1) padding at the tail, int64 ids past 2**31."""
    v = rng.standard_normal((p, qn, kk)).astype(np.float32)
    if ties:
        v = np.round(v * 2)
    v = -np.sort(-v, axis=2)
    i = rng.integers(0, 1 << 40, (p, qn, kk)).astype(np.int64)
    if pad:
        v[:, :, kk - pad:] = -np.inf
        i[:, :, kk - pad:] = -1
    return torch.from_numpy(v), torch.from_numpy(i)


@pytest.mark.parametrize("p,qn,kk,k,n_valid,pad", [
    (2, 1, 1, 1, -1, 0), (2, 37, 10, 10, -1, 4), (4, 300, 16, 7, 60, 0),
    (3, 70, 64, 256, -1, 20), (8, 9, 100, 100, 777, 30),
    (4, 5, 300, 1000, -1, 90), (2, 4, 1000, 1500, 1999, 0),
    (5, 6, 130, 600, 640, 13),
])
def test_topk_merge_kernel_matches_plain(cuda, p, qn, kk, k, n_valid, pad):
    rng = np.random.default_rng(kk + k)
    vals, ids = _windows(rng, p, qn, kk, pad=pad, ties=p == 3)
    if p == 4 and qn == 5:
        vals[1], ids[1] = -np.inf, -1             # an all-padding shard
    vals, ids = vals.to(cuda), ids.to(cuda)
    before = merge_ops.launches.n
    kv, ki = merge_topk_dev(vals, ids, k, n_valid=n_valid)
    pv, pi = merge_topk_ref(vals, ids, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert merge_ops.launches.n == before + 1
    assert ki.dtype == torch.int64
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


def test_topk_merge_kernel_tie_order(cuda):
    """All ties: the lower flattened column comes first."""
    vals = torch.zeros(3, 4, 6, device=cuda)
    ids = torch.arange(72, device=cuda).reshape(3, 4, 6)
    kv, ki = merge_topk_dev(vals, ids, 9)
    flat = ids.permute(1, 0, 2).reshape(4, 18)
    assert torch.equal(ki, flat[:, :9])


def _pq_ext_inputs(rng, qn, n, mb, cuda):
    """bias, sorted row buckets, bucket scores and a probe mask with a query
    that probes nothing and one that probes a single bucket."""
    pm = torch.from_numpy(rng.random((qn, mb)) < 0.4)
    pm[0] = False
    if qn > 1:
        pm[1] = False
        pm[1, 2] = True
    return dict(bias=torch.from_numpy(rng.standard_normal(n).astype(
                    np.float32)).to(cuda),
                row_bucket=torch.from_numpy(np.sort(rng.integers(
                    0, mb, n)).astype(np.int32)).to(cuda),
                cscores=torch.from_numpy(rng.standard_normal(
                    (qn, mb)).astype(np.float32)).to(cuda),
                probe_mask=pm.to(cuda))


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("k", [1, 80, 255, 256, 800, 2990])
def test_pq_kernel_query_chunks(cuda, monkeypatch, ext, k):
    """Past SCRATCH_BYTES of scores the queries go in chunks: one scoring
    launch a chunk, counted by the form it serves, results joined in query
    order, equal to the plain version bitwise (float LUTs, sums in its
    order), at k up to n_valid."""
    rng = np.random.default_rng(k)
    qn, n, n_valid = 30, 3001, 2990
    luts = torch.from_numpy(rng.standard_normal((qn, 16, 256)).astype(
        np.float32)).to(cuda)
    codes = torch.from_numpy(rng.integers(0, 256, (n, 16)).astype(
        np.uint8)).to(cuda)
    kw = _pq_ext_inputs(rng, qn, n, 7, cuda) if ext else {}
    ld = -(-n_valid // 4) * 4
    monkeypatch.setattr(pq_ops, "SCRATCH_BYTES", 4 * ld * 7)   # 7 queries
    counter = pq_ops.ext_launches if ext else pq_ops.launches
    before = counter.n
    kv, ki = pq_adc_topk(luts, codes, k, n_valid=n_valid, **kw)
    pv, pi = pq_adc_topk_ref(luts, codes, k, n_valid=n_valid, **kw)
    torch.cuda.synchronize()
    assert counter.n == before + 5                 # ceil(30 / 7) chunks
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    if ext:
        assert bool((ki[0] == -1).all())


@pytest.mark.parametrize("m,ksub,qn,offset", [
    (8, 256, 30, 0), (12, 16, 3, 0), (16, 256, 1, 0), (16, 256, 4, 0),
    (16, 256, 13, 1), (64, 256, 5, 0), (16, 256, 9, 0), (64, 256, 9, 0),
])
def test_pq_kernel_code_widths(cuda, m, ksub, qn, offset):
    """Every scoring instantiation: 4 or 1 query slots a block (by the
    query count and the LUT size; 64 x 256 leaves room for one at any
    count), 16-byte code loads at M = 16 and byte loads otherwise (other
    M, or a code table that starts off a 16-byte boundary), against the
    plain version, plain and extended."""
    rng = np.random.default_rng(m * ksub + qn)
    n = 1537
    luts = torch.from_numpy(rng.standard_normal((qn, m, ksub)).astype(
        np.float32)).to(cuda)
    buf = torch.from_numpy(rng.integers(0, ksub, n * m + offset).astype(
        np.uint8)).to(cuda)
    codes = buf[offset:].view(n, m)
    for kw in ({}, _pq_ext_inputs(rng, qn, n, 5, cuda)):
        kv, ki = pq_adc_topk(luts, codes, 100, **kw)
        pv, pi = pq_adc_topk_ref(luts, codes, 100, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("qn,n,k,min_segment", [
    (3, 5000, 1, 64), (3, 5000, 100, 64), (3, 5000, 1000, 64),
    (2, 200_000, 800, None), (255, 40_000, 80, 64),
])
def test_pq_kernel_segments(cuda, monkeypatch, ext, qn, n, k, min_segment):
    """With few queries each row's selection is cut into segments, a block
    each (2 x 200,000 rows at k' = 800: 12 of them; a small MIN_SEGMENT
    forces up to 78), and the survivors' sort still gives the plain
    top-k, ties to the lower row."""
    if min_segment is not None:
        monkeypatch.setattr(pq_ops, "MIN_SEGMENT", min_segment)
    rng = np.random.default_rng(n + k)
    luts = torch.from_numpy(rng.integers(-3, 4, (qn, 16, 16)).astype(
        np.float32)).to(cuda)                      # integer sums: many ties
    codes = torch.from_numpy(rng.integers(0, 16, (n, 16)).astype(
        np.uint8)).to(cuda)
    kw = _pq_ext_inputs(rng, qn, n, 6, cuda) if ext else {}
    assert pq_ops.select_segments(qn, n - 7, k) > 1
    kv, ki = pq_adc_topk(luts, codes, k, n_valid=n - 7, **kw)
    pv, pi = pq_adc_topk_ref(luts, codes, k, n_valid=n - 7, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("p,qn,kk,k,n_valid,pad", [
    (4, 256, 10, 10, -1, 2), (4, 33, 100, 100, 350, 10),
    (2, 5, 256, 250, -1, 0), (3, 7, 171, 150, 510, 5),
    (2, 5, 1024, 1000, -1, 0), (3, 7, 683, 500, 2046, 5),
    (8, 3, 10002, 10002, 75015, 1000),
])
def test_topk_merge_kernel_paths(cuda, monkeypatch, id_dtype, p, qn, kk, k,
                                 n_valid, pad):
    """Both paths on the same windows: the one-launch path (C <= SMALL_COLS;
    C = 512 is the cut) and the radix selection (forced by SMALL_COLS = 0,
    and taken from C = 513 on anyway), int64 and int32 ids, an all-padding
    shard, columns past n_valid; equal to the plain merge."""
    rng = np.random.default_rng(kk + k)
    vals, ids = _windows(rng, p, qn, kk, pad=pad, ties=True)
    vals[1], ids[1] = -np.inf, -1                     # an all-padding shard
    vals, ids = vals.to(cuda), ids.to(id_dtype).to(cuda)
    pv, pi = merge_topk_ref(vals, ids, k, n_valid=n_valid)
    for small_cols in (merge_ops.SMALL_COLS, 0):
        monkeypatch.setattr(merge_ops, "SMALL_COLS", small_cols)
        before = merge_ops.launches.n
        kv, ki = merge_topk_dev(vals, ids, k, n_valid=n_valid)
        torch.cuda.synchronize()
        assert merge_ops.launches.n == before + 1
        assert ki.dtype == id_dtype
        assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_topk_merge_small_window_is_one_launch(cuda):
    """The cluster kNN's merge (P = 4, Q = 256, k = 10) runs one kernel and
    nothing else on the card: no copy, no fill, no torch kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(4)
    vals, ids = (t.to(cuda) for t in _windows(rng, 4, 256, 10, pad=2))
    merge_topk_dev(vals, ids, 10)                     # builds and loads
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        merge_topk_dev(vals, ids, 10)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(on_card) == 1 and "merge_small" in on_card[0], on_card


def test_index_on_card_matches_cpu(cuda):
    """One index state on the card and on the CPU: every search mode gives
    the same ids and scores."""
    from repro_torch.configs.pandadb import VectorIndexConfig
    from repro_torch.core.vector_index import IVFIndex
    rng = np.random.default_rng(3)
    n, d, m = 5000, 32, 8
    st = {"vectors": rng.integers(-3, 4, (n, d)).astype(np.float32),
          "centroids": rng.integers(-2, 3, (m, d)).astype(np.float32),
          "bucket_of": np.sort(rng.integers(0, m, n)),
          "ids": np.arange(n) * 3,
          "codebooks": rng.integers(-2, 3, (8, 16, 4)).astype(np.float32),
          "codes": rng.integers(0, 16, (n, 8)).astype(np.uint8)}
    for residual in (False, True):
        cfg = VectorIndexConfig(dim=d, pq_m=8, pq_bits=4, nprobe=3,
                                pq_residual=residual, rerank_mult=2)
        if residual:
            st["code_bias"] = rng.integers(-9, 9, n).astype(np.float32)
        on_card = IVFIndex.from_state(st, cfg, device=cuda)
        on_cpu = IVFIndex.from_state(st, cfg, device="cpu")
        q = rng.integers(-3, 4, (64, d)).astype(np.float32)
        for kw in (dict(mode="float"), dict(mode="adc"),
                   dict(mode="fused"), dict(mode="adc", rerank=False),
                   dict(mode="float", nprobe=m)):
            a = on_card.search_many(q, 50, **kw)
            b = on_cpu.search_many(q, 50, **kw)
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[0], b[0])


def test_index_maps_ids_on_card_at_the_join_shape(cuda):
    """The face join's batch (Q = 1,024, k = 100, 448,626 cosine rows in 4
    buckets): ``search_many``'s ids, mapped on the card, equal the host
    mapping ``ids[idx]`` of the same kernel's selection, on the grouped
    and the dense path; after a compaction the resident ids are the host
    ids and the mapping holds again."""
    from repro_torch.configs.pandadb import VectorIndexConfig
    from repro_torch.core.vector_index import (METRICS, IVFIndex,
                                               pairwise_scores, stable_topk)
    rng = np.random.default_rng(30)
    n, d, m, qn, k = 448_626, 128, 4, 1_024, 100
    rows = rng.standard_normal((n, d), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    st = {"vectors": rows,
          "centroids": rng.standard_normal((m, d), dtype=np.float32),
          "bucket_of": np.sort(rng.integers(0, m, n)),
          "ids": rng.permutation(n) * 7 + 10 ** 10}
    cfg = VectorIndexConfig(dim=d, metric="cosine", min_buckets=m, nprobe=8,
                            pending_compact_min=1_000,
                            pending_compact_frac=0.0)
    index = IVFIndex.from_state(st, cfg, device=cuda)
    q = rng.standard_normal((qn, d), dtype=np.float32)

    def host_mapped(nprobe):
        qt = torch.from_numpy(q).to(cuda)
        if nprobe >= m:
            vals, idx = ivf_scan_topk(qt, index.t_vectors, k, "cosine")
            return vals.cpu().numpy(), index.ids[idx.cpu().numpy()]
        _, probe = stable_topk(pairwise_scores(qt, index.t_centroids,
                                               "cosine"), nprobe)
        mask = torch.zeros((qn, m), dtype=torch.uint8, device=cuda)
        mask.scatter_(1, probe, 1)
        vals, idx = ivf_scan_topk(qt, index.t_vectors, k, "cosine",
                                  row_bucket=index.t_bucket32,
                                  probe_mask=mask)
        vals = vals.cpu().numpy()
        return vals, np.where(np.isfinite(vals),
                              index.ids[idx.cpu().numpy()], -1)

    def check():
        assert index.t_ids.dtype == torch.int64
        np.testing.assert_array_equal(index.t_ids.cpu().numpy(), index.ids)
        for nprobe, path in ((8, "grouped"), (2, "dense")):
            c0 = METRICS.snapshot()["counters"]
            v, i = index.search_many(q, k, nprobe)
            c1 = METRICS.snapshot()["counters"]
            assert c1[f"ivf.path.{path}"] - c0[f"ivf.path.{path}"] == 1
            hv, hi = host_mapped(nprobe)
            assert i.dtype == np.int64
            np.testing.assert_array_equal(v, hv)
            np.testing.assert_array_equal(i, hi)

    check()
    old = index.t_ids
    new = rng.standard_normal((1_000, d), dtype=np.float32)
    index.insert_many(new, 2 * 10 ** 10 + np.arange(1_000))
    assert index.pending_count == 0 and index.t_ids is not old
    assert len(index.ids) == n + 1_000
    check()


def test_cluster_on_card_matches_cpu(cuda):
    """A 4-shard cluster on the card and on the CPU: fan-out rows and kNN
    ids agree, and the card's kNN merge launched the kernel."""
    from repro_torch.cluster import FaultInjector
    from repro_torch.launch.serve import CLUSTER_QUERIES, build_cluster
    card = build_cluster(600, 4, 1, FaultInjector(0), device=cuda)
    cpu = build_cluster(600, 4, 1, FaultInjector(0), device="cpu")
    for q in CLUSTER_QUERIES:
        text, params = q if isinstance(q, tuple) else (q, None)
        assert card.query(text, params) == cpu.query(text, params)
    q = np.random.default_rng(0).standard_normal((40, 64)).astype(np.float32)
    before = (merge_ops.launches.n, ivf_ops.launches.n)
    for k in (10, 100):
        cv, ci = card.knn("face", q, k)
        pv, pi = cpu.knn("face", q, k)
        np.testing.assert_array_equal(ci, pi)
        np.testing.assert_allclose(cv, pv, rtol=1e-5, atol=1e-4)
    assert merge_ops.launches.n == before[0] + 2
    assert ivf_ops.launches.n > before[1]
    card.close()
    cpu.close()


def test_query_on_card_matches_cpu(cuda):
    from repro_torch.core import PandaDB
    from repro_torch.core.aipm import feature_hash_extractor
    from repro_torch.data.synthetic_graph import SNBConfig, build_snb

    def make(device):
        db = PandaDB(device=device)
        db.register_extractor("face", feature_hash_extractor(dim=128))
        build_snb(db, SNBConfig(n_persons=800, n_identities=260))
        db.build_index("face", "photo")
        return db

    card, cpu = make(cuda), make("cpu")
    text = ("MATCH (n:Person)-[:knows]->(m:Person) WHERE n.photo->face ~: "
            "m.photo->face RETURN n.name, m.name")
    before = ivf_ops.launches.n
    assert card.query(text) == cpu.query(text)
    assert ivf_ops.launches.n > before


# -- the LM's attention kernels ----------------------------------------------

# bf16: the kernel and the plain version round float32 values that differ by
# float32 noise only, so they land at most one bf16 ulp apart (<= 2^-7 |x|),
# with float32 noise near zero; float32: the kernel sums in another order.
# chip_smoke.py holds the kernels to the same limits.
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen).to(device=device, dtype=dtype)


def _assert_attn_close(got, want, tol, slack=0.0):
    """Every element within atol + rtol |want| + slack (a number or a
    tensor like ``want``)."""
    assert got.shape == want.shape
    g, w = got.float(), want.float()
    over = (g - w).abs() - (tol["atol"] + tol["rtol"] * w.abs() + slack)
    assert float(over.max()) <= 0.0, (
        f"max |delta| {float((g - w).abs().max())}, past the limit by "
        f"{float(over.max())}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,causal,bf16_probs", [
    (2, 128, 4, 4, 64, True, False), (1, 100, 8, 2, 128, True, False),
    (2, 257, 8, 1, 160, True, False), (1, 64, 16, 2, 128, False, False),
    (3, 33, 4, 1, 32, True, True), (1, 1, 2, 1, 16, True, False),
    (2, 190, 8, 8, 128, False, True),
])
def test_flash_kernel_matches_plain(cuda, dtype, b, s, h, kvh, d, causal,
                                    bf16_probs):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (bf16_probs_slack,
                                                         flash_attention_ref)
    gen = torch.Generator().manual_seed(s * h + d)
    q = _randn(gen, b, s, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, s, kvh, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, s, kvh, d, dtype=dtype, device=cuda)
    before = flash_ops.launches.n
    got = flash_ops.flash_attention(q, k, v, causal=causal,
                                    bf16_probs=bf16_probs)
    # with bf16_probs both sides round each key tile's weights on that
    # tile's running max; a weight on a bf16 midpoint may round either way
    kt = flash_ops.key_tile(d, dtype)
    want = flash_attention_ref(q, k, v, causal=causal, bf16_probs=bf16_probs,
                               block_kv=kt)
    slack = bf16_probs_slack(q, k, v, causal=causal, block_kv=kt) \
        if bf16_probs else 0.0
    torch.cuda.synchronize()
    assert flash_ops.launches.n == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attn_close(got, want, ATTN_TOL[dtype], slack)


@pytest.mark.parametrize("s", [1, 33, 64, 257, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 192, 256])
@pytest.mark.parametrize("h,kvh", [(8, 2), (4, 4)])
@pytest.mark.parametrize("bf16_probs", [False, True])
def test_flash_wgmma_kernel_every_width(cuda, s, d, h, kvh, bf16_probs):
    """The bf16 wgmma kernel at every equal width of HEAD_DIMS, short and
    ragged S, GQA and MHA, causal and not, against the plain version
    rounding on the kernel's key tiles."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (bf16_probs_slack,
                                                         flash_attention_ref)
    assert (d, d) in flash_ops.HEAD_DIMS
    gen = torch.Generator().manual_seed(s * 1000 + d + h)
    q = _randn(gen, 2, s, h, d, dtype=torch.bfloat16, device=cuda)
    k = _randn(gen, 2, s, kvh, d, dtype=torch.bfloat16, device=cuda)
    v = _randn(gen, 2, s, kvh, d, dtype=torch.bfloat16, device=cuda)
    kt = flash_ops.key_tile(d)
    for causal in (True, False):
        before = flash_ops.launches.n
        got = flash_ops.flash_attention(q, k, v, causal=causal,
                                        bf16_probs=bf16_probs)
        want = flash_attention_ref(q, k, v, causal=causal,
                                   bf16_probs=bf16_probs, block_kv=kt)
        # a weight on a bf16 midpoint may round either way on either side
        slack = bf16_probs_slack(q, k, v, causal=causal, block_kv=kt) \
            if bf16_probs else 0.0
        torch.cuda.synchronize()
        assert flash_ops.launches.n == before + 1
        _assert_attn_close(got, want, ATTN_TOL[torch.bfloat16], slack)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,dv,causal,bf16_probs", [
    (1, 100, 300, 8, 2, 128, 128, True, False),   # Sq < Skv
    (1, 130, 257, 4, 4, 64, 64, False, True),
    (2, 300, 100, 4, 2, 64, 64, True, False),     # Sq > Skv
    (1, 200, 200, 8, 2, 192, 128, True, False),   # MLA's prefill widths
    (1, 200, 333, 8, 2, 192, 128, True, True),
    (1, 64, 64, 4, 2, 32, 16, True, False),       # Dv padded to 32
    (1, 100, 100, 4, 1, 80, 80, True, False),     # D padded to 128
    (1, 129, 129, 4, 2, 256, 256, True, False),
    (1, 70, 150, 4, 2, 192, 192, False, True),
    (2, 50, 90, 6, 3, 100, 7, True, False),       # both padded
])
def test_flash_kernel_serves_the_reference_shapes(cuda, dtype, b, sq, skv, h,
                                                  kvh, d, dv, causal,
                                                  bf16_probs):
    """Unequal lengths, Dv != D and widths outside the compiled pairs, on
    the kernel (one launch, any padding made by the wrapper) against the
    plain version at the true widths."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (bf16_probs_slack,
                                                         flash_attention_ref)
    gen = torch.Generator().manual_seed(sq * 7 + skv + d + dv)
    q = _randn(gen, b, sq, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, skv, kvh, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, skv, kvh, dv, dtype=dtype, device=cuda)
    before = flash_ops.launches.n
    got = flash_ops.flash_attention(q, k, v, causal=causal,
                                    bf16_probs=bf16_probs)
    kt = flash_ops.key_tile(d, dtype, dv)
    want = flash_attention_ref(q, k, v, causal=causal, bf16_probs=bf16_probs,
                               block_kv=kt)
    slack = bf16_probs_slack(q, k, v, causal=causal, block_kv=kt) \
        if bf16_probs else 0.0
    torch.cuda.synchronize()
    assert flash_ops.launches.n == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, h, dv)
    _assert_attn_close(got, want, ATTN_TOL[dtype], slack)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,window,bf16_probs", [
    (2, 300, 300, 8, 2, 128, 1, False),            # each row itself alone
    (1, 257, 257, 4, 4, 64, 300, False),           # w >= S: causal
    (2, 700, 700, 8, 2, 128, 100, False),          # w not a key tile's
    (1, 1000, 1000, 8, 1, 128, 256, True),
    (1, 200, 900, 8, 2, 128, 333, False),          # Sq < Skv, right-aligned
    (1, 130, 513, 4, 2, 64, 64, True),
    (1, 300, 300, 4, 2, 192, 70, False),           # WK = 64
])
def test_flash_window_matches_plain(cuda, dtype, b, sq, skv, h, kvh, d,
                                    window, bf16_probs):
    """A sliding window on the kernel (one launch: the bf16 kernel skips
    the key tiles below each block's band) against the plain version's
    band mask, at the edges of the band."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (bf16_probs_slack,
                                                         flash_attention_ref)
    gen = torch.Generator().manual_seed(sq + skv * 3 + window)
    q = _randn(gen, b, sq, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, skv, kvh, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, skv, kvh, d, dtype=dtype, device=cuda)
    before = flash_ops.launches.n
    got, m, l = flash_ops.flash_attention(q, k, v, bf16_probs=bf16_probs,
                                          window=window, return_stats=True)
    kt = flash_ops.key_tile(d, dtype)
    want, wm, wl = flash_attention_ref(q, k, v, bf16_probs=bf16_probs,
                                       block_kv=kt, window=window,
                                       return_stats=True)
    slack = bf16_probs_slack(q, k, v, block_kv=kt, window=window) \
        if bf16_probs else 0.0
    torch.cuda.synchronize()
    assert flash_ops.launches.n == before + 1
    _assert_attn_close(got, want, ATTN_TOL[dtype], slack)
    # the row statistics are the band's: m its largest scaled score, l the
    # weights' sum (a row's first tiles below its band leave nothing)
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_at_the_mellum2_cell_shape(cuda, dtype):
    """B 1, S 32,768, 32 query heads over 4 key heads of 128, window 1,024
    (Mellum2's sliding layers at the cell's positions) against the plain
    version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator().manual_seed(1024)
    s = 32768
    q = _randn(gen, 1, s, 32, 128, dtype=dtype, device=cuda)
    k = _randn(gen, 1, s, 4, 128, dtype=dtype, device=cuda)
    v = _randn(gen, 1, s, 4, 128, dtype=dtype, device=cuda)
    got = flash_ops.flash_attention(q, k, v, window=1024)
    want = flash_attention_ref(q, k, v, window=1024,
                               block_kv=flash_ops.key_tile(128, dtype))
    torch.cuda.synchronize()
    _assert_attn_close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,d", [(4096, 4096, 128), (300, 700, 64),
                                      (64, 64, 192)])
def test_flash_window_over_every_key_is_the_causal_kernel(cuda, dtype, sq,
                                                          skv, d):
    """A window as wide as the keys runs the window instantiation over the
    causal kernel's tiles with the same masks: the same output, bit for
    bit."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    gen = torch.Generator().manual_seed(sq + d)
    q = _randn(gen, 1, sq, 8, d, dtype=dtype, device=cuda)
    k = _randn(gen, 1, skv, 2, d, dtype=dtype, device=cuda)
    v = _randn(gen, 1, skv, 2, d, dtype=dtype, device=cuda)
    causal = flash_ops.flash_attention(q, k, v)
    wide = flash_ops.flash_attention(q, k, v, window=skv)
    torch.cuda.synchronize()
    assert torch.equal(causal, wide)


def test_flash_window_refuses_what_it_does_not_serve(cuda):
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.attention import chunked_attention
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention(x, x, x, causal=False, window=4)
    with pytest.raises(NotImplementedError, match="windowed"):
        chunked_attention(x.requires_grad_(), x, x, window=4)


def _select_inputs(case):
    """(q, corpus, k, n_valid) of the selection's tie cases on the card."""
    rng = np.random.default_rng(len(case))
    if case == "ties_across_tiles":
        base = _int(rng, 40, 8, lo=-1, hi=2)
        return _int(rng, 6, 8, lo=-1, hi=2), base.repeat(60, 1), 777, 2400
    if case == "all_equal_rows":
        return _int(rng, 5, 16), torch.zeros(3000, 16), 1234, 3000
    if case == "k_one":
        return _int(rng, 9, 32), _int(rng, 5000, 32), 1, 4999
    if case == "k_is_n_valid":
        return _int(rng, 4, 16), _int(rng, 2000, 16), 1990, 1990
    if case == "k_past_256_tiles":
        return _int(rng, 3, 4, lo=-1, hi=2), _int(rng, 70_000, 4, lo=-1,
                                                  hi=2), 65_600, 70_000
    if case == "padding_rows":
        q = _int(rng, 3, 16)
        return q, torch.cat([_int(rng, 777, 16), q.repeat(90, 1)]), 700, 777
    raise KeyError(case)


@pytest.mark.parametrize("case", ["ties_across_tiles", "all_equal_rows",
                                  "k_one", "k_is_n_valid", "k_past_256_tiles",
                                  "padding_rows"])
def test_ivf_select_kernel_ties(cuda, case):
    """ivf_select against the plain radix selection and the full stable
    sort: ids identical, values equal (integer scores are exact)."""
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_select_ref
    from repro_torch.kernels.topk import radix_select_ref
    q, c, k, n_valid = _select_inputs(case)
    q, c = q.to(cuda), c.to(cuda)
    scores = ivf_ops.ivf_scores(q, c, True)
    kv, ki = ivf_ops.ivf_select(scores, n_valid, k)
    rv, ri = radix_select_ref(scores[:, :c.shape[0]], n_valid, k)
    torch.cuda.synchronize()
    assert torch.equal(ki, ri) and torch.equal(kv, rv)   # row order
    got = ivf_scan_topk(q, c, k, n_valid=n_valid)
    want = ivf_scan_topk_ref(q, c, k, n_valid=n_valid)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert torch.equal(got[1], ivf_scan_select_ref(q, c, k,
                                                   n_valid=n_valid)[1])
    assert int(got[1].max()) < n_valid


@pytest.mark.parametrize("k", [10, 300])
def test_ivf_kernel_query_chunks(cuda, monkeypatch, k):
    """Past SCRATCH_BYTES of scores the queries go in chunks: one scoring
    launch a chunk, results joined in query order, equal to the plain
    version."""
    rng = np.random.default_rng(k)
    qn, n, d, n_valid = 30, 2001, 32, 1990
    q, c = _int(rng, qn, d).to(cuda), _int(rng, n, d).to(cuda)
    ld = -(-n // 4) * 4                       # the scores' padded row
    monkeypatch.setattr(ivf_ops, "SCRATCH_BYTES", 4 * ld * 7)   # 7 queries
    before = ivf_ops.launches.n
    kv, ki = ivf_scan_topk(q, c, k, n_valid=n_valid)
    pv, pi = ivf_scan_topk_ref(q, c, k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert ivf_ops.launches.n == before + 5    # ceil(30 / 7) chunks
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d,dv", [
    (2, 1000, 8, 2, 64, 64), (3, 4096, 32, 8, 128, 128),
    (2, 77, 16, 2, 160, 160), (1, 300, 8, 1, 128, 128), (4, 513, 4, 4, 32, 32),
    (2, 10, 4, 2, 16, 16),
    (2, 1000, 8, 2, 64, 32),        # Dv != D
    (2, 700, 16, 2, 192, 128),      # MLA's widths
    (2, 600, 32, 2, 64, 64),        # G = 16
    (3, 900, 8, 4, 96, 96),         # a width outside the old list
    (2, 500, 24, 1, 20, 36),        # G = 24 (two row groups), rows of
                                    # 40 / 72 bytes in bf16: element copies
    (2, 333, 4, 1, 256, 256),       # the widest
    (1, 2000, 2, 2, 8, 8),          # G = 1
])
def test_decode_kernel_matches_plain(cuda, dtype, b, s, h, kvh, d, dv):
    """pos = S - 1 (every key), pos = 0 (one key, every chunk but the first
    skipped) and random positions in between."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    gen = torch.Generator().manual_seed(s + h + d)
    q = _randn(gen, b, 1, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, s, kvh, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, s, kvh, dv, dtype=dtype, device=cuda)
    pos = torch.randint(0, s, (b,), generator=gen, dtype=torch.int32)
    pos[0] = s - 1
    pos[-1] = 0
    pos = pos.to(cuda)
    before = decode_ops.launches.n
    got = decode_ops.decode_attention(q, k, v, pos)
    want = decode_attention_ref(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_ops.launches.n == before + 1
    assert got.shape == (b, 1, h, dv)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,d", [(2, 1000, 8, 2, 64),
                                         (3, 4096, 32, 8, 128),
                                         (2, 77, 16, 2, 160)])
def test_decode_kernel_log_sum_exp_matches_plain(cuda, dtype, b, s, h, kvh,
                                                 d):
    """The rows' log-sum-exp that a rank of a position-sharded decode keeps
    beside its output (``_with_lse``: from the kernel's chunk partials on
    the card) against the plain scores' on the CPU; positions at S - 1, 0
    and between."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    gen = torch.Generator().manual_seed(s + h)
    q = _randn(gen, b, 1, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, s, kvh, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, s, kvh, d, dtype=dtype, device=cuda)
    pos = torch.randint(0, s, (b,), generator=gen, dtype=torch.int32)
    pos[0], pos[-1] = s - 1, 0
    scale = d ** -0.5
    out, lse = decode_ops._with_lse(q, k, v, pos.to(cuda), scale)
    want_out, want_lse = decode_ops._with_lse(q.cpu(), k.cpu(), v.cpu(), pos,
                                              scale)
    torch.cuda.synchronize()
    assert lse.shape == (b, h) and lse.dtype == torch.float32
    torch.testing.assert_close(out.float().cpu(), want_out.float(),
                               **ATTN_TOL[dtype])
    torch.testing.assert_close(lse.cpu(), want_lse, rtol=1e-4, atol=1e-3)


def test_attention_on_card_never_takes_the_plain_version(cuda, monkeypatch):
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    def refuse(*a, **kw):
        raise AssertionError("a card tensor reached the plain version")

    monkeypatch.setattr(flash_ops, "flash_attention_ref", refuse)
    monkeypatch.setattr(decode_ops, "decode_attention_ref", refuse)
    x = torch.randn(1, 8, 2, 64, device=cuda)
    flash_ops.flash_attention(x, x, x)
    decode_ops.decode_attention(x[:, :1], x, x,
                                torch.tensor([3], dtype=torch.int32,
                                             device=cuda))
    torch.cuda.synchronize()


def test_lm_on_card_matches_cpu(cuda):
    """A 2-layer float32 LM with the same weights on the card and on the
    CPU: logits within 1e-4 and the same greedy tokens, with both attention
    kernels launched on the card."""
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.transformer import LM
    cfg = TransformerConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                            head_dim=32, d_ff=256, vocab_size=512,
                            dtype="float32")
    card = LM(cfg, device=cuda)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.randint(0, 512, (2, 37), generator=torch.Generator()
                         .manual_seed(0))
    before = (flash_ops.launches.n, decode_ops.launches.n)
    outs = []
    for model in (card, cpu):
        last, pre = model.prefill(toks)
        cache = model.init_cache(2, 45)
        for dst, src in zip(cache["dense"], pre["dense"]):
            dst[:, :, :37] = src
        logits, tokens = [last.cpu()], [last.argmax(-1).cpu()]
        for t in range(8):
            lg, cache = model.decode_step(cache, tokens[-1][:, None],
                                          torch.full((2,), 37 + t))
            logits.append(lg.cpu())
            tokens.append(lg.argmax(-1).cpu())
        outs.append((torch.stack(logits), torch.stack(tokens)))
    assert flash_ops.launches.n > before[0]
    assert decode_ops.launches.n > before[1]
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# MoE, MLA and the collectives on the card
# ---------------------------------------------------------------------------

# the "moe" and "mla" configs of tests/test_models_lm.py, and the two
# together with a dense first layer (deepseek-v2's shape, cut small)
_SMALL_LMS = {
    "moe": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, moe_d_ff=32, vocab_size=256,
                n_routed_experts=8, n_shared_experts=2, top_k=2,
                dtype="float32", capacity_factor=4.0),
    "mla": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                vocab_size=256, kv_lora_rank=32, q_lora_rank=48,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                dtype="float32"),
    "moe_mla": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                    d_ff=96, moe_d_ff=32, vocab_size=256,
                    n_routed_experts=8, n_shared_experts=2, top_k=3,
                    kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16, dtype="float32",
                    capacity_factor=1.0),
}


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_ffn_on_card_matches_cpu(cuda, capacity_factor):
    """The MoE layer with the same weights on the card and the CPU, with
    and without experts overflowing: outputs within 1e-5, aux equal."""
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.models import moe
    cfg = TransformerConfig(**dict(_SMALL_LMS["moe"],
                                   capacity_factor=capacity_factor))
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(cfg, torch.float32, torch.device("cpu"),
                                 gen)
    x = torch.randn(3, 40, 64, generator=gen)
    want, want_aux = moe.moe_ffn(params, x, cfg)

    def to_card(p):
        return {k: to_card(v) for k, v in p.items()} if isinstance(p, dict) \
            else p.to(cuda)

    got, aux = moe.moe_ffn(to_card(params), x.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=1e-6)


def test_dropless_moe_on_card_matches_its_plain_version(cuda):
    """The dropless MoE layer in bf16 on the card, whose experts run as
    grouped products (``torch._grouped_mm``), against the same layer in
    float32 with one product an expert (``grouped_mm``'s plain branch),
    at DeepSeek-V2-Lite's widths (64 experts of 1,408, top-6, 2 shared)
    over 2 x 512 tokens: within bf16's rounding of the experts' inputs,
    weights and outputs (3e-2 of outputs of order 1)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = get_arch("deepseek-v2-lite").model
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.init_moe_params(cfg, torch.bfloat16, cuda, gen)
    x = torch.randn(2, 512, cfg.d_model, generator=gen, device=cuda)
    got, _ = moe.moe_ffn(params, x.bfloat16(), cfg)

    def f32(p):
        return {k: f32(v) for k, v in p.items()} if isinstance(p, dict) \
            else p.float()

    want, _ = moe.moe_ffn(f32(params), x.bfloat16().float(),
                          dataclasses.replace(cfg, dtype="float32"))
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("name", list(_SMALL_LMS))
def test_moe_and_mla_lms_on_card_match_cpu(cuda, name):
    """MoE, MLA and MoE + MLA LMs with the same weights on the card and the
    CPU: prefill, then 8 greedy decode steps (MLA's through the absorbed
    decode): logits within 1e-4, the same tokens."""
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.transformer import LM
    cfg = TransformerConfig(**_SMALL_LMS[name])
    card = LM(cfg, device=cuda)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    b, s, steps = 2, 29, 8
    toks = torch.randint(0, 256, (b, s), generator=torch.Generator()
                         .manual_seed(1))
    before = flash_ops.launches.n
    outs = []
    for model in (card, cpu):
        last, pre = model.prefill(toks)
        cache = model.init_cache(b, s + steps)
        for key in cache:
            for dst, src in zip(cache[key], pre[key]):
                dst[:, :, :s] = src
        logits, tokens = [last.cpu()], [last.argmax(-1).cpu()]
        for t in range(steps):
            lg, cache = model.decode_step(cache, tokens[-1][:, None],
                                          torch.full((b,), s + t))
            logits.append(lg.cpu())
            tokens.append(lg.argmax(-1).cpu())
        outs.append((torch.stack(logits), torch.stack(tokens)))
    assert flash_ops.launches.n - before == cfg.n_layers
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,dv", [(2, 300, 16, 128, 128),
                                        (1, 257, 8, 192, 128)])
def test_attention_kernels_one_query_head_per_key_head(cuda, dtype, b, s, h,
                                                       d, dv):
    """flash and decode at G = 1 (deepseek-moe-16b's 16 / 16 heads, MLA's
    prefill widths), against their plain versions."""
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator().manual_seed(s + h)
    q = _randn(gen, b, s, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, s, h, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, s, h, dv, dtype=dtype, device=cuda)
    got = flash_ops.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    _assert_attn_close(got, want, ATTN_TOL[dtype])
    pos = torch.randint(0, s, (b,), generator=gen, dtype=torch.int32)
    pos[0] = s - 1
    pos = pos.to(cuda)
    q1 = q[:, :1].contiguous()
    got = decode_ops.decode_attention(q1, k, v, pos)
    want = decode_attention_ref(q1, k, v, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])


def test_collectives_on_a_world_one_nccl_group(cuda, tmp_path):
    """sharded_topk on one NCCL rank (one card takes one rank) through the
    topk_merge kernel equals the whole-corpus scan; partial_softmax_combine
    equals the plain softmax."""
    import torch.distributed as dist
    from repro_torch.core.vector_index import scan_topk
    from repro_torch.distributed.collectives import (partial_softmax_combine,
                                                     sharded_topk)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        rng = np.random.default_rng(0)
        half = _int(rng, 500, 32)
        corpus = torch.cat([half, half]).to(cuda)
        ids = torch.arange(1000, device=cuda) + (1 << 33)
        q = _int(rng, 7, 32).to(cuda)
        for k in (10, 100):
            before = merge_ops.launches.n
            v, i = sharded_topk(q, corpus, ids, k)
            wv, wi = scan_topk(q, corpus, ids, k)
            torch.cuda.synchronize()
            assert merge_ops.launches.n == before + 1
            assert torch.equal(i, wi) and torch.equal(v, wv)
        s = torch.randn(3, 4, 300, device=cuda)
        vals = torch.randn(3, 4, 300, 16, device=cuda)
        got = partial_softmax_combine(s, vals)
        want = torch.einsum("...s,...sd->...d", torch.softmax(s, -1), vals)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the attention backward and the training path on the card
# ---------------------------------------------------------------------------

# the backward's limit (chip_smoke.py's BWD_TOL): rtol |want| + atol * max
# |want|.  bf16: both sides compute float32 gradients and round them once,
# one bf16 ulp apart, plus float32 noise of long sums that cancel in small
# elements; float32: sums in another order.
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 2.0 ** -10)}


def _assert_grad_close(got, want, dtype):
    rtol, atol = BWD_TOL[dtype]
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    over = (g - w).abs() - (rtol * w.abs() + atol * float(w.abs().max()))
    assert float(over.max()) <= 0.0, (
        f"max |delta| {float((g - w).abs().max())} against max |want| "
        f"{float(w.abs().max())}")


def _bwd_case(cuda, dtype, b, sq, skv, h, kvh, d, dv, causal, seed):
    """q, k, v, dO on the card and the forward kernel's (o, m, l)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    gen = torch.Generator().manual_seed(seed)
    q = _randn(gen, b, sq, h, d, dtype=dtype, device=cuda)
    k = _randn(gen, b, skv, kvh, d, dtype=dtype, device=cuda)
    v = _randn(gen, b, skv, kvh, dv, dtype=dtype, device=cuda)
    do = _randn(gen, b, sq, h, dv, dtype=dtype, device=cuda)
    o, m, l = flash_ops.flash_attention(q, k, v, causal=causal,
                                        return_stats=True)
    return q, k, v, do, o, m, l


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,dv", [
    (2, 96, 96, 4, 4, 32, 32),        # G = 1
    (1, 130, 130, 8, 2, 32, 32),      # G = 4, ragged
    (1, 64, 64, 4, 1, 48, 32),        # D padded to 64
    (1, 100, 100, 4, 1, 192, 128),    # MLA's widths
    (2, 40, 150, 4, 1, 64, 64),       # Sq < Skv
    (1, 150, 60, 8, 2, 32, 32),       # Sq > Skv: rows that see no key
    (1, 4096, 4096, 32, 8, 128, 128),  # the training shape's S and heads
    (2, 200, 200, 4, 1, 128, 128),    # S ragged against 64 and 128
    (1, 1000, 1000, 8, 2, 64, 64),    # likewise, more tiles
    (1, 300, 300, 16, 2, 128, 128),   # G = 8
    (1, 400, 200, 8, 2, 64, 64),      # Sq > Skv by three query tiles
    (1, 100, 400, 8, 2, 64, 64),      # Sq < Skv by more than a key tile
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, b, sq, skv, h, kvh, d,
                                        dv, causal):
    """dq, dk, dv of the backward kernel against flash_attention_bwd_ref on
    the same (o, m, l), one launch; and m, l of the forward kernel against
    the plain version's."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    q, k, v, do, o, m, l = _bwd_case(cuda, dtype, b, sq, skv, h, kvh, d, dv,
                                     causal, sq + skv + d + dv + h)
    _, pm, pl = flash_attention_ref(q, k, v, causal=causal,
                                    return_stats=True)
    torch.testing.assert_close(m, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, pl, rtol=1e-4, atol=0)
    before = flash_ops.bwd_launches.n
    got = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do, causal=causal)
    want = flash_attention_bwd_ref(q, k, v, o, m, l, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.bwd_launches.n == before + 1
    for g, w in zip(got, want):
        _assert_grad_close(g, w, dtype)


@pytest.mark.parametrize("d,dv", [(16, 16), (32, 32), (64, 64), (128, 128),
                                  (160, 160), (192, 192), (256, 256),
                                  (192, 128)])
def test_flash_bwd_kernel_every_compiled_pair(cuda, d, dv):
    """The bf16 wgmma backward at every compiled (D, Dv) pair, causal,
    GQA, a ragged S."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    q, k, v, do, o, m, l = _bwd_case(cuda, torch.bfloat16, 2, 77, 77, 4, 2,
                                     d, dv, True, d + dv)
    got = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do)
    want = flash_attention_bwd_ref(q, k, v, o, m, l, do)
    for g, w in zip(got, want):
        _assert_grad_close(g, w, torch.bfloat16)


def test_flash_bwd_two_launches_agree_within_the_limit(cuda):
    """Two launches of the bf16 backward on the same inputs agree within
    the backward's limit.  They need not agree bitwise: dq's float32 sums
    are added to by TMA reductions (atomics for the widest heads) from
    every key tile's block, in whatever order the blocks reach them, and
    float32 addition is not associative.  dk and dv are summed in
    registers in a fixed order and written once, so they do agree
    bitwise."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    q, k, v, do, o, m, l = _bwd_case(cuda, torch.bfloat16, 2, 1000, 1000, 8,
                                     2, 128, 128, True, 11)
    first = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do)
    second = flash_ops.flash_attention_bwd(q, k, v, o, m, l, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        _assert_grad_close(b, a, torch.bfloat16)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])


def test_flash_bwd_on_card_never_takes_the_plain_version(cuda, monkeypatch):
    from repro_torch.kernels.flash_attention import ops as flash_ops

    def refuse(*a, **k):
        raise AssertionError("plain backward on the card")

    monkeypatch.setattr(flash_ops, "flash_attention_bwd_ref", refuse)
    q, k, v, do, o, m, l = _bwd_case(cuda, torch.bfloat16, 1, 64, 64, 2, 1,
                                     64, 64, True, 0)
    flash_ops.flash_attention_bwd(q, k, v, o, m, l, do)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_attention_gradient_on_card_matches_cpu(cuda, dtype):
    """Autograd through the model's chunked_attention: on the card the
    forward and backward kernels (one launch each), on the CPU the plain
    versions; the gradients agree within the backward's limit."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(2, 70, h, 64, generator=gen).to(dtype)
          for h in (8, 2, 2)]
    do = torch.randn(2, 70, 8, 64, generator=gen).to(dtype)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_() for x in xs]
        before = (flash_ops.launches.n, flash_ops.bwd_launches.n)
        out = chunked_attention(*leaves, causal=True)
        out.backward(do.to(dev))
        after = (flash_ops.launches.n, flash_ops.bwd_launches.n)
        assert after == ((before[0] + 1, before[1] + 1) if dev.type == "cuda"
                         else before)
        grads.append([x.grad.cpu() for x in leaves])
    for g, w in zip(*grads):
        _assert_grad_close(g, w, dtype)


@pytest.mark.parametrize("name", ["dense", "moe", "mla"])
def test_lm_loss_and_train_step_on_card_match_cpu(cuda, name):
    """loss_fn's loss and gradients, and the parameters after one
    train_step at grad_accum 2, with the same weights on the card (the
    attention kernels, forward and backward) and on the CPU: within 1e-4."""
    from repro_torch.configs.base import TransformerConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import train_step
    from repro_torch.models.transformer import LM
    from repro_torch.training.optimizer import init_opt_state
    kw = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
              d_ff=256, vocab_size=512, dtype="float32") \
        if name == "dense" else _SMALL_LMS[name]
    cfg = TransformerConfig(**dict(kw, grad_accum=2))
    card = LM(cfg, device=cuda)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (4, 31), generator=gen)
    labs = torch.randint(0, cfg.vocab_size, (4, 31), generator=gen)
    res = []
    for model in (card, cpu):
        before = flash_ops.bwd_launches.n
        loss, _ = model.loss_fn(toks, labs)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        if model is card:
            assert flash_ops.bwd_launches.n == before + cfg.n_layers
        _, met = train_step(model, init_opt_state(params), toks, labs)
        res.append((loss.detach().cpu(), [g.cpu() for g in grads],
                    met["loss"].cpu(),
                    [p.detach().cpu() for p in params.values()]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(res[0][2], res[1][2], rtol=1e-4, atol=1e-4)
    for a, b in zip(res[0][1] + res[0][3], res[1][1] + res[1][3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# gather_scatter, the GNN family's SpMM
# ---------------------------------------------------------------------------


def _gs_inputs(cuda, n, e, d, dtype, seed, empty=5):
    """x [n, d], edges (int32) with `empty` rows that get none, weights
    with a fifth of them 0 (masked), on the card."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen).to(dtype)
    src = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, n - empty, (e,), generator=gen, dtype=torch.int32)
    w = torch.randn(e, generator=gen) * (torch.rand(e, generator=gen) > 0.2)
    return x.to(cuda), src.to(cuda), dst.to(cuda), w.to(cuda)


def _gs_limit(x, src, dst, n, w, reduce):
    """1e-5 x each element's sum |w x| (over its count for the mean)."""
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    return 1e-5 * gather_scatter_ref(x.float().abs(), src, dst, n,
                                     None if w is None else w.abs(), reduce)


@pytest.mark.parametrize("d", [1, 7, 16, 100, 128, 602, 1433])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_scatter_kernel_matches_plain(cuda, d, reduce, weighted):
    """Ragged widths (scalar, float2 and float4 loads), empty rows, masked
    edges, trailing dims flattened: within 1e-5 of each element's sum |w x|
    of the plain version on the card, and bit for bit equal to the plain
    version on the CPU, which sums in the kernel's edge order."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    n, e = 700, 5000
    x, src, dst, w = _gs_inputs(cuda, n, e, d, torch.float32, d)
    w = w if weighted else None
    before = gs_ops.launches.n
    got = gs_ops.gather_scatter(x, src, dst, n, w, reduce)
    assert gs_ops.launches.n == before + 1
    want = gather_scatter_ref(x, src, dst, n, w, reduce)
    assert ((got - want).abs() <= _gs_limit(x, src, dst, n, w, reduce)).all()
    assert (got[n - 5:] == 0).all()
    cpu = gather_scatter_ref(x.cpu(), src.cpu(), dst.cpu(), n,
                             None if w is None else w.cpu(), reduce)
    assert torch.equal(got.cpu(), cpu)
    x3 = x.reshape(n, 1, d)                           # [N, 1, d] flattened
    assert torch.equal(gs_ops.gather_scatter(x3, src, dst, n, w, reduce),
                       got.reshape(n, 1, d))


@pytest.mark.parametrize("n", [20_000, 40_000])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_gather_scatter_kernel_many_rows_walk_their_tiles(cuda, reduce, n):
    """Many rows at d = 300 (three column tiles): a work item is a tile of
    consecutive rows, streamed through one warp's ring and written row by
    row, as many rows as give each resident warp one item (20,000 rows: 19
    an item with 3 blocks of 8 warps on each of 132 SMs), or 8 where that
    would pass 32 (40,000 rows): still bit for bit the CPU's plain
    version."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    e, d = 3 * n, 300
    x, src, dst, w = _gs_inputs(cuda, n, e, d, torch.float32, 11)
    got = gs_ops.gather_scatter(x, src, dst, n, w, reduce)
    assert torch.equal(got.cpu(), gather_scatter_ref(
        x.cpu(), src.cpu(), dst.cpu(), n, w.cpu(), reduce))


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_scatter_kernel_bf16(cuda, weighted):
    """bf16 x: with float32 weights the output is float32 (bf16 * float32
    promotes, as in the plain version) and equals the plain version's
    bits on the CPU; with no weights the kernel sums in float32 and rounds
    once to bf16, within one bf16 rounding of the float32 sum."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    n, e, d = 500, 4000, 128
    x, src, dst, w = _gs_inputs(cuda, n, e, d, torch.bfloat16, 5)
    w = w if weighted else None
    got = gs_ops.gather_scatter(x, src, dst, n, w, "mean")
    f32 = gather_scatter_ref(x.float(), src, dst, n, w, "mean")
    if weighted:
        assert got.dtype == torch.float32
        assert torch.equal(got.cpu(), gather_scatter_ref(
            x.cpu(), src.cpu(), dst.cpu(), n, w.cpu(), "mean"))
    else:
        assert got.dtype == torch.bfloat16
        assert ((got.float() - f32).abs() <= 2.0 ** -8 * f32.abs()
                + _gs_limit(x, src, dst, n, w, "mean")).all()


def test_gather_scatter_planted_fault_fails_the_limit(cuda):
    """One edge's term dropped (its weight zeroed) puts the kernel past the
    limit the tests hold it to."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    n, e = 300, 3000
    x, src, dst, w = _gs_inputs(cuda, n, e, 64, torch.float32, 6)
    lim = _gs_limit(x, src, dst, n, w, "sum")
    want = gather_scatter_ref(x, src, dst, n, w, "sum")
    bad = w.clone()
    bad[int(torch.argmax(w.abs()))] = 0.0
    got = gs_ops.gather_scatter(x, src, dst, n, bad, "sum")
    assert not ((got - want).abs() <= lim).all()


def test_gather_scatter_backward_gradcheck_and_kernel(cuda):
    """The plain version's gradient passes gradcheck in float64 on the CPU;
    the kernel's backward (the same kernel over the CSR by source, the
    mean's 1 / count folded into the weights) matches the plain version's
    autograd within 1e-5 of each element's sum |w g|, and a planted fault
    in the backward's weights fails that limit."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    gen = torch.Generator().manual_seed(7)
    n, e = 12, 40
    x = torch.randn(n, 3, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    src = torch.randint(0, n, (e,), generator=gen)
    dst = torch.randint(0, n - 2, (e,), generator=gen)
    w = torch.randn(e, dtype=torch.float64, generator=gen)
    for reduce in ("sum", "mean"):
        assert torch.autograd.gradcheck(
            lambda t: gather_scatter_ref(t, src, dst, n, w, reduce), (x,))
    n, e, d = 600, 6000, 96
    x, src, dst, w = _gs_inputs(cuda, n, e, d, torch.float32, 8)
    g = torch.randn(n, d, device=cuda)
    for reduce in ("sum", "mean"):
        xg = x.clone().requires_grad_()
        before = gs_ops.launches.n
        (dk,) = torch.autograd.grad(
            gs_ops.gather_scatter(xg, src, dst, n, w, reduce), xg, g)
        assert gs_ops.launches.n == before + 2
        (dp,) = torch.autograd.grad(
            gather_scatter_ref(xg, src, dst, n, w, reduce), xg, g)
        cnt = torch.bincount(dst.long(), minlength=n).clamp(min=1)
        wb = w.abs() / (cnt[dst.long()] if reduce == "mean" else 1)
        lim = 1e-5 * gather_scatter_ref(g.abs(), dst, src, n, wb, "sum")
        assert ((dk - dp).abs() <= lim).all(), reduce
    bad = w.clone()
    bad[int(torch.argmax(w.abs()))] = 0.0
    xg = x.clone().requires_grad_()
    (df,) = torch.autograd.grad(
        gs_ops.gather_scatter(xg, src, dst, n, bad, "sum"), xg, g)
    (dp,) = torch.autograd.grad(
        gather_scatter_ref(xg, src, dst, n, w, "sum"), xg, g)
    lim = 1e-5 * gather_scatter_ref(g.abs(), dst, src, n, w.abs(), "sum")
    assert not ((df - dp).abs() <= lim).all()


def test_gather_scatter_on_card_never_takes_the_plain_version(cuda,
                                                              monkeypatch):
    from repro_torch.kernels.gather_scatter import ops as gs_ops

    def refuse(*a, **k):
        raise AssertionError("plain gather_scatter on the card")

    monkeypatch.setattr(gs_ops, "gather_scatter_ref", refuse)
    x, src, dst, w = _gs_inputs(cuda, 50, 200, 8, torch.float32, 9)
    gs_ops.gather_scatter(x, src, dst, 50, w, "mean")
    with pytest.raises(ValueError, match="gradient"):
        gs_ops.gather_scatter(x, src, dst, 50, w.requires_grad_(), "sum")
    torch.cuda.synchronize()


def _hub_graph(cuda, d, dtype, seed, hub_edges=50_000):
    """x [3,000, d], 20,000 random edges plus ``hub_edges`` into node 5 (a
    long row of the forward's CSR) and as many out of node 9 (a long row
    of the backward's), shuffled; weights with a fifth of them 0."""
    rng = np.random.default_rng(seed)
    n, e = 3000, 20_000
    src = np.concatenate([rng.integers(0, n, e + hub_edges),
                          np.full(hub_edges, 9)])
    dst = np.concatenate([rng.integers(0, n - 4, e), np.full(hub_edges, 5),
                          rng.integers(0, n - 4, hub_edges)])
    order = rng.permutation(src.size)
    src, dst = src[order], dst[order]
    w = (rng.standard_normal(src.size) * (rng.random(src.size) > 0.2)
         ).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    return (x.to(dtype).to(cuda), torch.from_numpy(src).to(torch.int32)
            .to(cuda), torch.from_numpy(dst).to(torch.int32).to(cuda),
            torch.from_numpy(w).to(cuda), n)


def _bwd_weights(w, dst, n, reduce):
    """The gradient's per-edge weights: w / max(count_dst, 1) for the
    mean (float32 division, as the kernel divides)."""
    if reduce == "sum":
        return w
    cnt = torch.bincount(dst.long(), minlength=n).float().clamp(min=1.0)
    return w / cnt[dst.long()]


@pytest.mark.parametrize("d", [1, 7, 128, 602])
def test_gather_scatter_hub_rows_split_by_columns(cuda, d):
    """A row of 50,000 edges in each direction, far past LONG_ROW, so the
    kernel takes it first and splits its columns over warps: the forward
    equals the CPU's plain version bit for bit, the backward equals the
    CPU's plain sum over the reversed edges with the mean's per-edge
    weights bit for bit, each CSR's work counter is back at 0 after its
    launches, and dropping one of a hub row's edges fails the 1e-5 limit
    each way."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    x, src, dst, w, n = _hub_graph(cuda, d, torch.float32, d)
    assert gs_ops.LONG_ROW < 50_000
    csr = gs_ops.EdgeCSR.build(src, dst, n)
    assert int(csr.rows.n_long[0]) == 1 and int(csr.rows.long_rows[0]) == 5
    assert int(csr.transposed().n_long[0]) == 1
    assert int(csr.transposed().long_rows[0]) == 9
    xc, sc, dc, wc = x.cpu(), src.cpu(), dst.cpu(), w.cpu()
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(d))
    for reduce in ("sum", "mean"):
        xg = x.clone().requires_grad_()
        got = gs_ops.gather_scatter(xg, src, dst, n, w, reduce, csr)
        want = gather_scatter_ref(xc, sc, dc, n, wc, reduce)
        assert torch.equal(got.detach().cpu(), want), reduce
        (dx,) = torch.autograd.grad(got, xg, g.to(cuda))
        ws = _bwd_weights(wc, dc, n, reduce)
        assert torch.equal(dx.cpu(), gather_scatter_ref(g, dc, sc, n, ws,
                                                        "sum")), reduce
    assert int(csr.rows.work[0]) == 0 and int(csr.transposed().work[0]) == 0
    # planted faults: the hub rows' largest terms dropped
    lim = _gs_limit(x, src, dst, n, w, "sum")
    want = gather_scatter_ref(x, src, dst, n, w, "sum")
    hub_f = torch.nonzero(dst == 5).flatten()
    bad = w.clone()
    bad[hub_f[torch.argmax(w[hub_f].abs() * x[src[hub_f].long()].abs()
                           .amax(1))]] = 0.0
    assert not ((gs_ops.gather_scatter(x, src, dst, n, bad, "sum", csr)
                 - want).abs() <= lim).all()
    gd = g.to(cuda)
    hub_b = torch.nonzero(src == 9).flatten()
    bad = w.clone()
    bad[hub_b[torch.argmax(w[hub_b].abs() * gd[dst[hub_b].long()].abs()
                           .amax(1))]] = 0.0
    xg = x.clone().requires_grad_()
    (df,) = torch.autograd.grad(
        gs_ops.gather_scatter(xg, src, dst, n, bad, "sum", csr), xg, gd)
    blim = 1e-5 * gather_scatter_ref(gd.abs(), dst, src, n, w.abs(), "sum")
    dp = gather_scatter_ref(gd, dst, src, n, w, "sum")
    assert not ((df - dp).abs() <= blim).all()


def test_gather_scatter_hub_rows_bf16(cuda):
    """bf16 x and no weights over the hub graph: the kernel sums in float32
    and rounds once at the store, forward and backward within one bf16
    rounding (2^-8 of the value) plus the 1e-5 limit of the float32 sums
    on the card."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    x, src, dst, _, n = _hub_graph(cuda, 128, torch.bfloat16, 3)
    g = torch.randn(n, 128, device=cuda).to(torch.bfloat16)
    for reduce in ("sum", "mean"):
        xg = x.clone().requires_grad_()
        got = gs_ops.gather_scatter(xg, src, dst, n, None, reduce)
        assert got.dtype == torch.bfloat16
        f32 = gather_scatter_ref(x.float(), src, dst, n, None, reduce)
        assert ((got.float() - f32).abs() <= 2.0 ** -8 * f32.abs()
                + _gs_limit(x, src, dst, n, None, reduce)).all(), reduce
        (dx,) = torch.autograd.grad(got, xg, g)
        assert dx.dtype == torch.bfloat16
        ws = _bwd_weights(torch.ones(src.numel(), device=cuda), dst, n,
                          reduce)
        b32 = gather_scatter_ref(g.float(), dst, src, n, ws, "sum")
        blim = 1e-5 * gather_scatter_ref(g.float().abs(), dst, src, n, ws,
                                         "sum")
        assert ((dx.float() - b32).abs() <= 2.0 ** -8 * b32.abs() + blim
                ).all(), reduce


@pytest.mark.parametrize("d", [1, 7, 602])
def test_gather_scatter_hub_rows_bf16_weighted(cuda, d):
    """bf16 x with float32 weights over the hub graph, at odd widths too
    (two-byte elements, which the kernel loads without cp.async) and on
    the long rows' column slices: the float32 output equals the CPU's plain
    version bit for bit, and the bf16 gradient is the CPU's plain float32
    sum over the reversed edges rounded once to bf16."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    x, src, dst, w, n = _hub_graph(cuda, d, torch.bfloat16, 10 + d)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(d))
    sc, dc, wc = src.cpu(), dst.cpu(), w.cpu()
    for reduce in ("sum", "mean"):
        xg = x.clone().requires_grad_()
        got = gs_ops.gather_scatter(xg, src, dst, n, w, reduce)
        assert got.dtype == torch.float32
        assert torch.equal(got.detach().cpu(), gather_scatter_ref(
            x.cpu(), sc, dc, n, wc, reduce)), reduce
        (dx,) = torch.autograd.grad(got, xg, g.to(cuda))
        assert dx.dtype == torch.bfloat16
        want = gather_scatter_ref(g, dc, sc, n, _bwd_weights(wc, dc, n,
                                                             reduce), "sum")
        assert torch.equal(dx.cpu(), want.to(torch.bfloat16)), reduce


def test_gather_scatter_runs_without_host_sync(cuda):
    """EdgeCSR.build (the sort, ptr by a search, the long rows' list), the
    forward and the backward (the CSR by source,
    the mean's scale in the kernel) raise nothing under
    torch.cuda.set_sync_debug_mode("error")."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    x, src, dst, w, n = _hub_graph(cuda, 64, torch.float32, 4, 5000)
    g = torch.randn(n, 64, device=cuda)
    gs_ops.gather_scatter(x, src, dst, n, w, "mean")     # built, loaded
    torch.cuda.synchronize()
    xg = x.clone().requires_grad_()
    torch.cuda.set_sync_debug_mode("error")
    try:
        csr = gs_ops.EdgeCSR.build(src, dst, n)
        out = gs_ops.gather_scatter(xg, src, dst, n, w, "mean", csr)
        (dx,) = torch.autograd.grad(out, xg, g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(dx).all()


@pytest.mark.parametrize("name", ["gcn", "graphsage", "gin", "gat", "schnet",
                                  "equiformer"])
def test_gnn_train_step_on_card_matches_cpu(cuda, name):
    """Each GNN at 2 layers, float32, the same weights on the card (SpMM
    through the kernel; GAT, SchNet and Equiformer add with atomics) and on
    the CPU: the loss, and every parameter after one gnn_train_step,
    within 1e-4."""
    from repro_torch.configs.base import GNNConfig
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.launch.gnn_steps import GNNCell, gnn_batch, \
        gnn_train_step
    from repro_torch.models.gnn import build_gnn
    from repro_torch.training.optimizer import init_opt_state
    extra = {"gat": dict(n_heads=2), "schnet": dict(n_rbf=16, cutoff=8.0),
             "equiformer": dict(l_max=2, m_max=1, n_heads=2, n_rbf=8,
                                cutoff=5.0)}.get(name, {})
    kind = "equiformer_v2" if name == "equiformer" else name
    cfg = GNNConfig(kind=kind, n_layers=2, d_hidden=8, n_classes=4, **extra)
    rng = np.random.default_rng(10)
    n, e = 80, 400
    arrays = {"feats": rng.standard_normal((n, 12)).astype(np.float32),
              "pos": rng.standard_normal((n, 3)).astype(np.float32),
              "src": rng.integers(0, n, e), "dst": rng.integers(0, n - 3, e),
              "edge_mask": rng.random(e) > 0.2,
              "labels": rng.integers(-1, 4, n)}
    cell = GNNCell(n_nodes=n, n_edges=e, d_feat=12, n_out=4, needs_pos=True,
                   shard_nodes=False, channel_shard=False, chunk=None)
    card = build_gnn(cfg, 12, 4, device=cuda)
    cpu = build_gnn(cfg, 12, 4, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    res = []
    for model, dev in ((card, cuda), (cpu, "cpu")):
        before = gs_ops.launches.n
        opt = init_opt_state(dict(model.named_parameters()))
        _, met = gnn_train_step(model, opt, gnn_batch(cell, arrays, dev),
                                cell)
        spmm = name in ("gcn", "graphsage", "gin")
        assert (gs_ops.launches.n > before) == (spmm and dev == cuda)
        res.append((met["loss"].cpu(),
                    [p.detach().cpu() for p in model.parameters()]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the recsys family: the embedding bag through gather_scatter, retrieval
# through ivf_scan
# ---------------------------------------------------------------------------


def _bag_inputs(cuda, b, f, v, d, h, seed, hub=True):
    """table [f, v, d] and ids [b, f, h] int32 on the card; with ``hub``
    id 3 of field 1 takes every bag's first slot (b edges: a long row of
    the gradient's CSR by source)."""
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(f, v, d, generator=gen)
    ids = torch.randint(0, v, (b, f, h), generator=gen, dtype=torch.int32)
    if hub:
        ids[:, 1, 0] = 3
    return table.to(cuda), ids.to(cuda)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_on_card_matches_cpu_bitwise(cuda, mode, weighted):
    """The dense bag through the gather_scatter kernel, with a hub id of
    300 edges (past the 64 of a long row): the forward equals the CPU's
    plain version bit for bit, the tables' gradient (unweighted) the CPU's
    plain sum over the reversed edges with the mean's 1 / H; one launch
    each way; weights that require a gradient raise."""
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref
    from repro_torch.models.recsys.embedding_bag import embedding_bag_dense
    b, f, v, d, h = 300, 3, 500, 16, 4
    table, ids = _bag_inputs(cuda, b, f, v, d, h, 21)
    w = (torch.randn(b, f, h, generator=torch.Generator().manual_seed(22))
         .to(cuda) if weighted else None)
    before = gs_ops.launches.n
    tg = table.clone().requires_grad_()
    got = embedding_bag_dense(tg, ids, mode, w)
    want = embedding_bag_dense(table.cpu(), ids.cpu(), mode,
                               None if w is None else w.cpu())
    assert torch.equal(got.detach().cpu(), want)
    assert gs_ops.launches.n == before + 1
    if weighted:
        with pytest.raises(ValueError, match="gradient"):
            embedding_bag_dense(table, ids, mode, w.requires_grad_())
        return
    g = torch.randn(b, f, d, generator=torch.Generator().manual_seed(23))
    (dt,) = torch.autograd.grad(got, tg, g.to(cuda))
    assert gs_ops.launches.n == before + 2
    src = (ids.cpu().long() + torch.arange(f)[None, :, None] * v).reshape(-1)
    dst = torch.arange(b * f).repeat_interleave(h)
    wb = torch.full((src.numel(),), 1.0 / h if mode == "mean" else 1.0)
    assert torch.equal(dt.cpu().reshape(f * v, d), gather_scatter_ref(
        g.reshape(b * f, d), dst, src, f * v, wb, "sum"))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_ragged_on_card_matches_cpu(cuda, mode):
    """Variable lengths, empty bags and a hub id: sum and mean through the
    kernel equal the CPU bit for bit; max (a torch scatter) too."""
    from repro_torch.models.recsys.embedding_bag import embedding_bag_ragged
    rng = np.random.default_rng(24)
    table = torch.from_numpy(rng.standard_normal((400, 16)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 400, 3000).astype(np.int32))
    ids[::7] = 11
    offsets = torch.from_numpy(np.sort(rng.integers(0, 3000, 200)).astype(
        np.int32))
    offsets[0] = 0
    got = embedding_bag_ragged(table.to(cuda), ids.to(cuda),
                               offsets.to(cuda), 200, mode)
    assert torch.equal(got.cpu(), embedding_bag_ragged(table, ids, offsets,
                                                       200, mode))


def test_autoint_retrieval_and_train_step_on_card_match(cuda):
    """A small AutoInt with the same weights on the card and the CPU: one
    recsys_train_step's loss and parameters within 1e-5; then retrieval
    through the ivf_scan kernel: ids equal to the plain version's on the
    card wherever neighbouring scores differ by more than 1e-5 of the
    largest, values within that."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref
    from repro_torch.launch.recsys_steps import (field_mask, recsys_model,
                                                 recsys_retrieval_step,
                                                 recsys_train_step)
    from repro_torch.training.optimizer import init_opt_state
    spec = get_arch("autoint")
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, n_sparse=7, vocab_per_field=300))
    rng = np.random.default_rng(25)
    ids = torch.from_numpy(rng.integers(0, 300, (64, 7, 4), dtype=np.int32))
    labels = torch.from_numpy(rng.integers(0, 2, 64).astype(np.float32))
    card = recsys_model(spec, device=cuda)
    cpu = recsys_model(spec, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    res = []
    for model, dev in ((card, cuda), (cpu, "cpu")):
        opt = init_opt_state(dict(model.named_parameters()))
        _, met = recsys_train_step(model, opt, ids.to(dev), labels.to(dev))
        res.append((met["loss"].cpu(),
                    [p.detach().cpu() for p in model.parameters()]))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=1e-5)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    with torch.no_grad():
        cands = card.representation(torch.from_numpy(rng.integers(
            0, 300, (5000, 7, 4), dtype=np.int32)).to(cuda),
            field_mask(card))
        qids = ids[:1].to(cuda)
        q = card.representation(qids, field_mask(card))
    vals, rows = recsys_retrieval_step(card, qids, cands)
    pv, pi = ivf_scan_topk_ref(q, cands, 100, "ip")
    tol = 1e-5 * float(pv.abs().max())
    pv, pi = pv[0].cpu(), pi[0].cpu()
    assert float((vals.cpu() - pv).abs().max()) <= tol
    gap = torch.full_like(pv, float("inf"))
    step = (pv[1:] - pv[:-1]).abs()
    gap[1:] = step
    gap[:-1] = torch.minimum(gap[:-1], step)
    sep = gap > tol
    assert torch.equal(rows.cpu()[sep], pi[sep])
