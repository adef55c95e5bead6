"""Two-sided vector-index tests: ``repro_torch.core.vector_index`` against
``repro.core.vector_index`` on identical index states.

Both indexes are made from one state of numpy arrays (the port through
``IVFIndex.from_state``, the reference through its constructor and append
buffers), so a search compares the scan paths alone, in every mode: the
Q=1 host path, probe-signature groups, the masked dense scan, staged ADC,
residual ADC, the fused scan, with and without pending appends and
re-rank.  States with integer-valued vectors, centroids and codebooks make
every score an exact float32 integer, so ids must match bitwise; scores
agree within rtol=atol=1e-5 (float32 sums in another order) where the state
is not integer-valued.  ``build`` itself is compared by agreement rate:
its k-means assignments are matmul argmaxes, and another summation order
can flip a near-tie.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.vector_index as rvi
from repro.configs.pandadb import VectorIndexConfig as RefCfg
from repro_torch.configs.pandadb import VectorIndexConfig as PortCfg
from repro_torch.core import vector_index as pvi
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    kw = {"pending_compact_min": 10 ** 6, **kw}
    return RefCfg(**kw), PortCfg(**kw)


def _pq_metric(cfg):
    return "ip" if cfg.pq_residual or cfg.metric in ("ip", "cosine") else "l2"


def _int_state(seed, n=600, d=16, m=6, pq_m=0, ksub=16, residual=False,
               pending=0, metric="l2"):
    """An integer-valued index state (+ both configs)."""
    rng = np.random.default_rng(seed)
    ref_cfg, port_cfg = _cfgs(dim=d, metric=metric, min_buckets=m,
                              vectors_per_bucket=10 ** 6, nprobe=2,
                              pq_m=pq_m, pq_bits=int(np.log2(ksub)),
                              pq_residual=residual, rerank_mult=3)
    st = {"vectors": rng.integers(-3, 4, (n, d)).astype(np.float32),
          "centroids": rng.integers(-2, 3, (m, d)).astype(np.float32),
          "bucket_of": np.sort(rng.integers(0, m, n)).astype(np.int64),
          "ids": rng.permutation(3 * n)[:n].astype(np.int64)}
    if pending:
        st["pend_bucket"] = np.sort(rng.integers(0, m, pending))
        st["pend_vectors"] = rng.integers(-3, 4, (pending, d)).astype(
            np.float32)
        st["pend_ids"] = (3 * n + np.arange(pending)).astype(np.int64)
    if pq_m:
        books = rng.integers(-2, 3, (pq_m, ksub, d // pq_m)).astype(
            np.float32)
        st["codebooks"] = books
        st["codes"] = rng.integers(0, ksub, (n, pq_m)).astype(np.uint8)
        if pending:
            st["pend_codes"] = rng.integers(0, ksub, (pending, pq_m)).astype(
                np.uint8)
        if residual:
            pq = rvi.PQCodebook(books, metric="ip")
            st["code_bias"] = rvi._residual_bias(
                pq, st["codes"], st["centroids"], st["bucket_of"], metric)
            if pending:
                st["pend_bias"] = rvi._residual_bias(
                    pq, st["pend_codes"], st["centroids"],
                    st["pend_bucket"], metric)
    return st, ref_cfg, port_cfg


def _ref_from_state(st, cfg):
    pq = (rvi.PQCodebook(st["codebooks"], metric=_pq_metric(cfg))
          if "codebooks" in st else None)
    idx = rvi.IVFIndex(cfg, st["centroids"], st["bucket_of"], st["vectors"],
                       st["ids"], pq=pq, codes=st.get("codes"),
                       code_bias=st.get("code_bias"))
    if "pend_bucket" in st:
        for i, b in enumerate(st["pend_bucket"].tolist()):
            idx._pend_vecs.setdefault(b, []).append(st["pend_vectors"][i])
            idx._pend_ids.setdefault(b, []).append(int(st["pend_ids"][i]))
            if "pend_codes" in st:
                idx._pend_codes.setdefault(b, []).append(
                    st["pend_codes"][i])
            if "pend_bias" in st:
                idx._pend_bias.setdefault(b, []).append(
                    float(st["pend_bias"][i]))
        idx.pending_count = len(st["pend_bucket"])
    return idx


def _pair(st, ref_cfg, port_cfg):
    return (_ref_from_state(st, ref_cfg),
            pvi.IVFIndex.from_state(st, port_cfg, device="cpu"))


def _queries(seed, layout, d=16, qn=9):
    rng = np.random.default_rng(seed + 7)
    if layout == "single":
        return rng.integers(-3, 4, (1, d)).astype(np.float32)
    if layout == "groups":
        # two distinct vectors repeated: at most two probe signatures
        base = rng.integers(-3, 4, (2, d)).astype(np.float32)
        return base[np.arange(qn) % 2]
    return rng.integers(-3, 4, (qn, d)).astype(np.float32)


def _same(a, b):
    (av, ai), (bv, bi) = a, b
    assert ai.shape == bi.shape and ai.dtype == bi.dtype
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_allclose(av, bv, **TOL)


# ---------------------------------------------------------------------------
# search on identical states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pending", [0, 37])
@pytest.mark.parametrize("k", [5, 250])
@pytest.mark.parametrize("layout", ["single", "groups", "dense", "exact"])
def test_flat_search_matches_reference(layout, k, pending):
    st, rc, pc = _int_state(1, pending=pending)
    ref, port = _pair(st, rc, pc)
    q = _queries(1, layout)
    nprobe = 6 if layout == "exact" else 2
    _same(port.search_many(q, k, nprobe), ref.search_many(q, k, nprobe))


@pytest.mark.parametrize("pending", [0, 23])
@pytest.mark.parametrize("rerank", [True, False])
@pytest.mark.parametrize("mode", ["adc", "fused"])
@pytest.mark.parametrize("residual", [False, True])
def test_pq_search_matches_reference(residual, mode, rerank, pending):
    st, rc, pc = _int_state(2, pq_m=4, residual=residual, pending=pending)
    ref, port = _pair(st, rc, pc)
    for layout in ("single", "groups", "dense"):
        q = _queries(2, layout)
        for k in (4, 90):
            _same(port.search_many(q, k, 2, mode=mode, rerank=rerank),
                  ref.search_many(q, k, 2, mode=mode, rerank=rerank))


@pytest.mark.parametrize("pq_m", [0, 4])
def test_ip_metric_matches_reference(pq_m):
    st, rc, pc = _int_state(3, pq_m=pq_m, metric="ip", pending=11)
    ref, port = _pair(st, rc, pc)
    for layout in ("single", "groups", "dense"):
        q = _queries(3, layout)
        _same(port.search_many(q, 20, 2), ref.search_many(q, 20, 2))


def _float_pair(n=2000, d=32, **kw):
    from repro.data.synthetic_graph import sift_like_vectors
    # scaled near unit norm: the l2 matmul identity cancels |q|^2 against
    # 2 q.c, and its rounding grows with the norms, not with the score
    vecs = sift_like_vectors(n, dim=d, n_clusters=16, seed=4) / 16
    rc, pc = _cfgs(dim=d, vectors_per_bucket=250, nprobe=3, **kw)
    ref = rvi.IVFIndex.build(vecs, cfg=rc, seed=0)
    port = pvi.IVFIndex.from_state(_state_of(ref), pc, device="cpu")
    return ref, port, vecs


def _state_of(ref):
    st = {"centroids": ref.centroids, "bucket_of": ref.bucket_of,
          "vectors": ref.vectors, "ids": ref.ids}
    if ref.pq is not None:
        st["codebooks"], st["codes"] = ref.pq.codebooks, ref.codes
    if ref.code_bias is not None:
        st["code_bias"] = ref.code_bias
    return st


@pytest.mark.parametrize("kw", [{}, {"pq_m": 8}, {"pq_m": 8,
                                                  "pq_residual": True},
                                {"metric": "cosine"}])
def test_float_state_from_reference_build(kw):
    """The reference's own built state (float vectors, trained codebooks):
    ids identical, scores within float32 summation slack."""
    ref, port, vecs = _float_pair(**kw)
    q = vecs[::97][:21] + np.float32(0.02)
    for mode in (("auto", "fused") if "pq_m" in kw else ("float",)):
        _same(port.search_many(q, 10, mode=mode),
              ref.search_many(q, 10, mode=mode))
    _same(port.search_exact(q, 10), ref.search_exact(q, 10))


# ---------------------------------------------------------------------------
# build, inserts, compaction, retrain, shard/merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_build_assignments_agree(metric):
    """k-means argmaxes over matmul scores: another summation order may flip
    a near tie, so assignments must agree on >= 99.9% of rows."""
    from repro.data.synthetic_graph import sift_like_vectors
    vecs = sift_like_vectors(3000, dim=32, n_clusters=24, seed=8)
    rc, pc = _cfgs(dim=32, metric=metric, vectors_per_bucket=300)
    ref = rvi.IVFIndex.build(vecs, cfg=rc, seed=3)
    port = pvi.IVFIndex.build(vecs, cfg=pc, seed=3, device="cpu")
    ref_b = dict(zip(ref.ids.tolist(), ref.bucket_of.tolist()))
    agree = np.mean([ref_b[i] == b for i, b in
                     zip(port.ids.tolist(), port.bucket_of.tolist())])
    assert agree >= 0.999
    assert port.centroids.shape == ref.centroids.shape


def test_insert_many_and_compact_match_reference():
    st, rc, pc = _int_state(5, pq_m=4, residual=True)
    ref, port = _pair(st, rc, pc)
    rng = np.random.default_rng(5)
    new = rng.integers(-3, 4, (40, 16)).astype(np.float32)
    new_ids = np.arange(10_000, 10_040)
    np.testing.assert_array_equal(port.insert_many(new, new_ids),
                                  ref.insert_many(new, new_ids))
    q = _queries(5, "dense")
    _same(port.search_many(q, 30, 2, mode="adc"),
          ref.search_many(q, 30, 2, mode="adc"))
    ref.compact()
    port.compact()
    for key, arr in _state_of(ref).items():
        np.testing.assert_array_equal(port.to_state()[key], arr)
    assert port.t_vectors.shape[0] == 640 and port.t_codes.shape[0] == 640
    _same(port.search_many(q, 30, 2, mode="fused"),
          ref.search_many(q, 30, 2, mode="fused"))


def test_single_inserts_match_reference():
    st, rc, pc = _int_state(6, pq_m=4)
    ref, port = _pair(st, rc, pc)
    rng = np.random.default_rng(6)
    for i in range(12):
        v = rng.integers(-3, 4, 16).astype(np.float32)
        assert port.insert(v, 50_000 + i) == ref.insert(v, 50_000 + i)
    q = _queries(6, "groups")
    _same(port.search_many(q, 15, 2), ref.search_many(q, 15, 2))


def test_retrain_pq_matches_reference():
    ref, port, vecs = _float_pair(pq_m=8, pq_residual=True)
    ref.retrain_pq(seed=2)
    port.retrain_pq(seed=2)
    np.testing.assert_array_equal(port.codes, ref.codes)
    np.testing.assert_array_equal(port.pq.codebooks, ref.pq.codebooks)
    np.testing.assert_array_equal(port.t_codes.numpy(), ref.codes)
    q = vecs[5:17]
    _same(port.search_many(q, 8, mode="adc"), ref.search_many(q, 8,
                                                             mode="adc"))


@pytest.mark.parametrize("strategy", ["hash", "roundrobin"])
def test_shard_and_merge_pieces_match_reference(strategy):
    st, rc, pc = _int_state(7, pq_m=4, residual=True, pending=9)
    ref, port = _pair(st, rc, pc)
    rs, ps = ref.shard(3, strategy=strategy), port.shard(3, strategy=strategy)
    for a, b in zip(rs, ps):
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.codes, a.codes)
        np.testing.assert_array_equal(b.code_bias, a.code_bias)
        assert b.device == port.device
    rm, pm = rvi.IVFIndex.merge_pieces(rs), pvi.IVFIndex.merge_pieces(ps)
    for key, arr in _state_of(rm).items():
        np.testing.assert_array_equal(pm.to_state()[key], arr)


def test_state_round_trip_keeps_pending_rows():
    st, _, pc = _int_state(8, pq_m=4, residual=True, pending=15)
    port = pvi.IVFIndex.from_state(st, pc, device="cpu")
    back = port.to_state()
    assert set(back) == set(st)
    for key in st:
        np.testing.assert_array_equal(back[key], st[key])


def _ref_pending(ref):
    """The reference's append buffers as ``to_state``'s ``pend_*`` arrays:
    buckets in ascending order, each bucket's rows in arrival order."""
    order = sorted(ref._pend_vecs)

    def walk(buffers):
        return [x for b in order for x in buffers.get(b, [])]

    out = {"pend_bucket": np.asarray(
               [b for b in order for _ in ref._pend_vecs[b]], np.int64),
           "pend_vectors": np.stack(walk(ref._pend_vecs)).astype(np.float32),
           "pend_ids": np.asarray(walk(ref._pend_ids), np.int64)}
    if walk(ref._pend_codes):
        out["pend_codes"] = np.stack(walk(ref._pend_codes)).astype(np.uint8)
    if walk(ref._pend_bias):
        out["pend_bias"] = np.asarray(walk(ref._pend_bias), np.float32)
    return out


@pytest.mark.parametrize("route", ["insert", "insert_many", "from_state"])
@pytest.mark.parametrize("kind", ["flat", "pq", "residual"])
def test_pending_rows_keep_bucket_then_arrival_order(kind, route):
    """Pending rows fed to both sides by one route (single inserts, one
    batch, a state listing them out of bucket order): the port's
    ``pend_*`` state is the reference's buffers walked in ascending bucket
    order, arrival order within a bucket, and searches of one query and of
    many give the reference's answers before and after compaction."""
    pq = {"flat": {}, "pq": {"pq_m": 4},
          "residual": {"pq_m": 4, "residual": True}}[kind]
    n_new = 29
    rng = np.random.default_rng(34)
    st, rc, pc = _int_state(34, pending=n_new if route == "from_state"
                            else 0, **pq)
    if route == "from_state":
        shuffle = rng.permutation(n_new)
        st.update({key: arr[shuffle] for key, arr in st.items()
                   if key.startswith("pend_")})
    ref, port = _pair(st, rc, pc)
    new = rng.integers(-3, 4, (n_new, 16)).astype(np.float32)
    new_ids = 20_000 + rng.permutation(n_new)
    if route == "insert":
        for v, i in zip(new, new_ids):
            assert port.insert(v, i) == ref.insert(v, i)
    elif route == "insert_many":
        np.testing.assert_array_equal(port.insert_many(new, new_ids),
                                      ref.insert_many(new, new_ids))
    assert port.pending_count == ref.pending_count == n_new
    state, want = port.to_state(), _ref_pending(ref)
    assert {key for key in state if key.startswith("pend_")} == set(want)
    for key, arr in want.items():
        assert state[key].dtype == arr.dtype
        np.testing.assert_array_equal(state[key], arr)

    def searches_agree():
        for layout, nprobe in (("single", 2), ("single", 6), ("groups", 2),
                               ("dense", 2), ("exact", 6)):
            q = _queries(34, layout)
            for k in (5, 60):
                _same(port.search_many(q, k, nprobe),
                      ref.search_many(q, k, nprobe))

    searches_agree()
    ref.compact()
    port.compact()
    assert port.pending_count == 0
    for key, arr in _state_of(ref).items():
        np.testing.assert_array_equal(port.to_state()[key], arr)
    searches_agree()


def test_recall_at_k_matches_reference():
    ref, port, vecs = _float_pair(pq_m=8)
    q = vecs[::101][:15]
    assert pvi.recall_at_k(port, q, 10, nprobe=2) == \
        rvi.recall_at_k(ref, q, 10, nprobe=2)


def test_stats_feedback_matches_reference():
    from repro.core.cost_model import StatisticsService as RefStats
    from repro_torch.core.cost_model import StatisticsService as PortStats
    ref, port, vecs = _float_pair(pq_m=8)
    rs, ps = RefStats(), PortStats()
    q = vecs[:6]
    _same(port.search_many(q, 5, stats=ps), ref.search_many(q, 5, stats=rs))
    assert port.scan_rows == ref.scan_rows > 0
    assert ps.epoch == rs.epoch


def test_unknown_mode_raises():
    st, _, pc = _int_state(9)
    port = pvi.IVFIndex.from_state(st, pc, device="cpu")
    with pytest.raises(ValueError):
        port.search_many(_queries(9, "dense"), 3, mode="bogus")


def test_entry_points_need_a_card_unless_told_cpu():
    """No device and no CUDA: build raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    vecs = np.random.default_rng(0).standard_normal((50, 8)).astype(
        np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pvi.IVFIndex.build(vecs, cfg=PortCfg(dim=8))
    idx = pvi.IVFIndex.build(vecs, cfg=PortCfg(dim=8), device="cpu")
    assert idx.t_vectors.device.type == "cpu"


def test_device_tables_mirror_host_arrays():
    st, _, pc = _int_state(10, pq_m=4, residual=True)
    port = pvi.IVFIndex.from_state(st, pc, device="cpu")
    np.testing.assert_array_equal(port.t_vectors.numpy(), port.vectors)
    np.testing.assert_array_equal(port.t_codes.numpy(), port.codes)
    np.testing.assert_array_equal(port.t_bias.numpy(), port.code_bias)
    np.testing.assert_array_equal(port.t_bucket32.numpy(), port.bucket_of)
    np.testing.assert_array_equal(port.t_ids.numpy(), port.ids)
    assert port.t_ids.dtype == torch.int64
    assert dataclasses.is_dataclass(port)


def test_config_matches_reference_but_the_tpu_tile():
    """Every index knob of the reference, with its default, except
    ``block_n``: the Pallas kernels' tile, to which the reference pads its
    corpora.  The port's CUDA kernels mask their own last tile of a fixed
    size and pad nothing."""
    ref = {f.name: f.default for f in dataclasses.fields(RefCfg)}
    port = {f.name: f.default for f in dataclasses.fields(PortCfg)}
    assert ref.pop("block_n") == 512
    assert port == ref


# ---------------------------------------------------------------------------
# the float scans' answers mapped to ids on the device
# ---------------------------------------------------------------------------


def _host_mapped(index, queries, k, nprobe):
    """(path, vals, ids) of a batched float search whose selected rows are
    mapped to ids on the host, ``ids[idx]`` in numpy: the same probe,
    groups and scan calls as ``search_many``, over the host rows."""
    qn, m = len(queries), index.centroids.shape[0]
    nprobe = min(nprobe, m)
    q = torch.from_numpy(queries)
    cs = pvi.pairwise_scores(q, index.t_centroids, index.cfg.metric)
    probe = np.sort(pvi.stable_topk(cs, nprobe)[1].numpy(), axis=1)
    sigs, inverse = np.unique(probe, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    out_v = np.full((qn, k), -np.inf, np.float32)
    out_i = np.full((qn, k), -1, np.int64)
    if len(sigs) > 1 and len(sigs) * nprobe >= m:
        corpus, ids, buckets = index._full_corpus()
        mask = np.zeros((qn, m), np.uint8)
        mask[np.arange(qn)[:, None], probe] = 1
        kk = min(k, len(ids))
        vals, idx = ivf_scan_topk(
            q, torch.from_numpy(corpus), kk, index.cfg.metric,
            row_bucket=torch.from_numpy(buckets.astype(np.int32)),
            probe_mask=torch.from_numpy(mask))
        vals, idx = vals.numpy(), idx.numpy()
        out_v[:, :kk] = vals
        out_i[:, :kk] = np.where(np.isfinite(vals), ids[idx], -1)
        return "dense", out_v, out_i
    for g, sig in enumerate(sigs):
        qsel = np.nonzero(inverse == g)[0]
        corpus, ids = index._gather_buckets(sig)
        if len(ids) == 0:
            continue
        kk = min(k, len(ids))
        vals, idx = ivf_scan_topk(
            torch.index_select(q, 0, torch.from_numpy(qsel)),
            torch.from_numpy(np.ascontiguousarray(corpus)), kk,
            metric=index.cfg.metric)
        cols = np.arange(kk)[None, :]
        out_v[qsel[:, None], cols] = vals.numpy()
        out_i[qsel[:, None], cols] = ids[idx.numpy()]
    return "grouped", out_v, out_i


def _same_as_host(index, queries, k, nprobe):
    """``search_many`` equals the host mapping bit for bit, on the path
    the host mapping took.  Returns the answers."""
    path, hv, hi = _host_mapped(index, queries, k, nprobe)
    paths0 = pvi.METRICS.snapshot()["counters"]
    v, i = index.search_many(queries, k, nprobe, mode="float")
    paths1 = pvi.METRICS.snapshot()["counters"]
    assert paths1[f"ivf.path.{path}"] - paths0[f"ivf.path.{path}"] == 1
    assert v.dtype == hv.dtype and i.dtype == hi.dtype == np.int64
    np.testing.assert_array_equal(v, hv)
    np.testing.assert_array_equal(i, hi)
    return path, v, i


def test_one_signature_cosine_k100_maps_on_device():
    """The face join's shape in small: every bucket probed (one
    signature, the whole batch), cosine, k = 100, ids not ``arange``."""
    rng = np.random.default_rng(30)
    vecs = rng.normal(size=(1_500, 16)).astype(np.float32)
    ids = rng.permutation(10 ** 6)[:1_500].astype(np.int64)
    cfg = PortCfg(dim=16, metric="cosine", min_buckets=4,
                  vectors_per_bucket=10 ** 6, nprobe=8)
    index = pvi.IVFIndex.build(vecs, ids=ids, cfg=cfg, device="cpu")
    queries = rng.normal(size=(64, 16)).astype(np.float32)
    path, v, i = _same_as_host(index, queries, 100, 8)
    assert path == "grouped" and (i >= 0).all()
    assert set(i.reshape(-1).tolist()) <= set(ids.tolist())


@pytest.mark.parametrize("ids_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("pending", [0, 37])
@pytest.mark.parametrize("layout", ["groups", "dense", "exact"])
def test_float_scans_map_on_device_as_on_host(layout, pending, ids_dtype):
    """Several signatures (``qsel`` subsets), the masked dense scan with
    queries whose probed rows number fewer than k (the -1 fill), and
    every bucket probed, with and without pending appends."""
    st, _, pc = _int_state(31, pending=pending)
    st["ids"] = st["ids"].astype(ids_dtype)
    index = pvi.IVFIndex.from_state(st, pc, device="cpu")
    if layout == "groups":
        q = np.repeat(_queries(31, "dense", qn=3), 4, axis=0)
        nprobe, k = 2, 250
    else:
        q = _queries(31, "dense", qn=48)
        nprobe, k = (2, 250) if layout == "dense" else (6, 40)
    sigs0 = pvi.METRICS.snapshot()["counters"]["ivf.signatures"]
    path, v, i = _same_as_host(index, q, k, nprobe)
    sigs = pvi.METRICS.snapshot()["counters"]["ivf.signatures"] - sigs0
    assert path == ("dense" if layout == "dense" else "grouped")
    assert (sigs > 1) == (layout != "exact")
    if layout != "exact":
        short = ~np.isfinite(v)
        assert short.any() and np.array_equal(short, i == -1)


def test_ids_uploaded_again_after_compaction():
    st, _, pc = _int_state(32)
    pc = dataclasses.replace(pc, pending_compact_min=50,
                             pending_compact_frac=0.0)
    index = pvi.IVFIndex.from_state(st, pc, device="cpu")
    rng = np.random.default_rng(32)
    new = rng.integers(-3, 4, (30, 16)).astype(np.float32)
    index.insert_many(new, 5_000 + np.arange(30))
    old = index.t_ids
    assert index.pending_count == 30
    for layout in ("groups", "dense"):
        _same_as_host(index, _queries(32, layout, qn=24), 60, 2)
    index.insert_many(new + 1, 6_000 + np.arange(30))
    assert index.pending_count == 0 and index.t_ids is not old
    assert len(index.ids) == 660
    np.testing.assert_array_equal(index.t_ids.numpy(), index.ids)
    for layout in ("groups", "dense"):
        _same_as_host(index, _queries(32, layout, qn=24), 60, 2)


def test_replica_piece_shares_ids_until_it_compacts():
    st, _, pc = _int_state(33)
    pc = dataclasses.replace(pc, pending_compact_min=50,
                             pending_compact_frac=0.0)
    piece = pvi.IVFIndex.from_state(st, pc, device="cpu")
    replica = piece.replica_view()
    assert replica.t_ids is piece.t_ids
    q = _queries(33, "dense", qn=24)
    _, v0, i0 = _same_as_host(replica, q, 60, 2)
    rng = np.random.default_rng(33)
    new = rng.integers(-3, 4, (30, 16)).astype(np.float32)
    replica.insert_many(new, 7_000 + np.arange(30))
    _same_as_host(replica, q, 60, 2)
    replica.insert_many(new - 1, 8_000 + np.arange(30))
    assert replica.t_ids is not piece.t_ids
    np.testing.assert_array_equal(replica.t_ids.numpy(), replica.ids)
    np.testing.assert_array_equal(piece.t_ids.numpy(), piece.ids)
    _same_as_host(replica, q, 60, 2)
    _, v1, i1 = _same_as_host(piece, q, 60, 2)
    np.testing.assert_array_equal(v1, v0)
    np.testing.assert_array_equal(i1, i0)


# ---------------------------------------------------------------------------
# probe signatures grouped as np.unique groups them
# ---------------------------------------------------------------------------


def _scattered(seed, qn, m, nprobe, dtype=np.int64):
    """A sorted [qn, nprobe] probe: each row ``nprobe`` distinct buckets of
    ``m``, drawn from the seed."""
    rng = np.random.default_rng(seed)
    pick = np.argsort(rng.random((qn, m)), axis=1)[:, :nprobe]
    return np.sort(pick, axis=1).astype(dtype)


#: case -> the sorted probe of one batch
SIGNATURE_PROBES = {
    "q2_same": lambda: np.array([[1, 4, 6], [1, 4, 6]], np.int64),
    "q2_distinct": lambda: np.array([[1, 4, 6], [1, 3, 6]], np.int64),
    "join_1024x4_all": lambda: np.tile(np.arange(4, dtype=np.int64),
                                       (1_024, 1)),
    "exact_256x10_all": lambda: np.tile(np.arange(10, dtype=np.int64),
                                        (256, 1)),
    "probe8_256x8_of_10": lambda: _scattered(32, 256, 10, 8),
    "nprobe_1": lambda: _scattered(33, 200, 7, 1),
    "m1000_nprobe32": lambda: _scattered(34, 300, 1_000, 32),
    "int32": lambda: _scattered(35, 128, 6, 3, np.int32),
    "q0": lambda: np.zeros((0, 3), np.int64),
}


@pytest.mark.parametrize("case", sorted(SIGNATURE_PROBES))
def test_group_signatures_equal_np_unique(case):
    """``search_many``'s grouping gives ``np.unique(axis=0)``'s signatures,
    in its order, and its inverse, element for element: the groups are
    visited in the same order, so every path writes the same answers."""
    probe = SIGNATURE_PROBES[case]()
    sigs, inverse = pvi._group_signatures(probe)
    want_sigs, want_inv = np.unique(probe, axis=0, return_inverse=True)
    assert sigs.dtype == want_sigs.dtype == probe.dtype
    assert sigs.shape == want_sigs.shape
    np.testing.assert_array_equal(sigs, want_sigs)
    assert inverse.dtype == np.int64 and inverse.shape == (len(probe),)
    np.testing.assert_array_equal(inverse, want_inv.reshape(-1))
    np.testing.assert_array_equal(sigs[inverse], probe)
