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
