"""Two-sided cluster tests: ``repro_torch.cluster`` against ``repro.cluster``.

Both coordinators get the same creation order (72 nodes, 32-d faces, as
tests/test_cluster.py builds them); the port's runs with ``device="cpu"``.
Rows, row order, routing and counters must be identical.  kNN ids must be
identical; scores agree with the reference within rtol=atol=1e-5 (float32
sums in another order: XLA's matmul against torch's), and bitwise with the
port's own single-node index, which is the cluster's contract: sharding is
a serving-layer concern, never a semantics change.
"""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.cluster as ref_cluster
import repro.configs.pandadb as ref_cfg
import repro.core as ref_core
import repro.core.aipm as ref_aipm
import repro.core.vector_index as ref_vi
import repro.serving.engine as ref_engine
import repro_torch.cluster as port_cluster
import repro_torch.configs.pandadb as port_cfg
import repro_torch.core as port_core
import repro_torch.core.aipm as port_aipm
import repro_torch.core.vector_index as port_vi
import repro_torch.serving.engine as port_engine
from repro.data.synthetic_graph import sift_like_vectors
from repro_torch.kernels.topk_merge import ops as merge_ops

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

N_NODES = 72
DIM = 32
TOL = dict(rtol=1e-5, atol=1e-5)

REF = types.SimpleNamespace(core=ref_core, aipm=ref_aipm, cluster=ref_cluster,
                            vi=ref_vi, cfg=ref_cfg, engine=ref_engine, dev={})
PORT = types.SimpleNamespace(core=port_core, aipm=port_aipm,
                             cluster=port_cluster, vi=port_vi, cfg=port_cfg,
                             engine=port_engine, dev={"device": "cpu"})
SIDES = (REF, PORT)


def _payloads(n=N_NODES, seed=3, dup_every=6):
    rng = np.random.default_rng(seed)
    base = rng.bytes(256)
    return base, [base if dup_every and i % dup_every == 0 else rng.bytes(256)
                  for i in range(n)]


#: duplicate photos every 6 nodes: semantic-filter queries get real matches
BASE, PAYLOADS = _payloads()
#: all-distinct photos: kNN parity needs no exact score ties
_, PAYLOADS_UNIQ = _payloads(seed=4, dup_every=0)

SEM_Q = ("MATCH (p:Person) WHERE p.photo->face ~: "
         "createFromSource($src)->face RETURN p.name")
LOOKUP = "MATCH (p:Person) WHERE p = $id RETURN p.name"


def _populate(side, db, payloads=PAYLOADS):
    db.register_extractor("face", side.aipm.feature_hash_extractor(dim=DIM))
    clustered = isinstance(db, side.cluster.ShardedPandaDB)
    cn = db.create_node if clustered else db.graph.create_node
    cr = db.create_relationship if clustered else db.graph.create_relationship
    nodes = [cn("Person", name=f"n{i}", rank=float(i % 7),
                photo=payloads[i]) for i in range(N_NODES)]
    for i in range(N_NODES - 1):
        cr(nodes[i], nodes[i + 1], "KNOWS")
    return db


def make_single(side, payloads=PAYLOADS, indexed=False):
    db = _populate(side, side.core.PandaDB(**side.dev), payloads)
    if indexed:
        db.build_index("face", "photo")
    return db


def make_cluster(side, n_shards, owner_fn=None, indexed=False,
                 payloads=PAYLOADS):
    c = _populate(side, side.cluster.ShardedPandaDB(
        n_shards, owner_fn=owner_fn, **side.dev), payloads)
    if indexed:
        c.build_index("face", "photo")
    return c


def both(fn):
    """fn(side) on the reference and on the port."""
    return fn(REF), fn(PORT)


def assert_knn_same(ref, port):
    rv, ri = (np.asarray(x) for x in ref)
    pv, pi = (np.asarray(x) for x in port)
    assert pi.dtype == np.int64
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, **TOL)


@pytest.fixture(scope="module")
def singles():
    return {name: both(lambda s: make_single(s, payloads, indexed))
            for name, payloads, indexed in (
                ("plain", PAYLOADS, False), ("indexed", PAYLOADS, True),
                ("knn", PAYLOADS_UNIQ, True))}


# -- kNN -----------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_knn_parity(singles, n_shards):
    """Scatter-gather kNN: the reference's ids and scores, and bitwise the
    port's single-node index, probe and exact widths."""
    _, single = singles["knn"]
    index = single.indexes["face"]
    q = np.random.default_rng(9).standard_normal((6, DIM)).astype(np.float32)
    ref, port = both(lambda s: make_cluster(s, n_shards, indexed=True,
                                            payloads=PAYLOADS_UNIQ))
    for nprobe in (2, index.centroids.shape[0]):
        got = port.knn("face", q, 5, nprobe=nprobe)
        assert_knn_same(ref.knn("face", q, 5, nprobe=nprobe), got)
        want = index.search_many(q, 5, nprobe=nprobe)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    ref.close()
    port.close()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_build_index_pieces_identical(n_shards):
    """Cluster BatchIndexing: every shard's piece (centroids, rows, ids)
    equals the reference's, and the port's pieces live on its device."""
    ref, port = both(lambda s: make_cluster(s, n_shards, indexed=True))
    for a, b in zip(ref.index_pieces("face"), port.index_pieces("face")):
        np.testing.assert_array_equal(b.centroids, a.centroids)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.vectors, a.vectors)
        assert b.t_vectors.device == port.device == torch.device("cpu")
    ref.close()
    port.close()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_parity_after_dynamic_insert(n_shards):
    """Insert-after-shard routing: new blobs land on their owner's piece;
    kNN and the semantic query stay identical to the reference."""
    rng = np.random.default_rng(21)
    new_payloads = [rng.bytes(256) for _ in range(5)]
    ref, port = both(lambda s: make_cluster(s, n_shards, indexed=True,
                                            payloads=PAYLOADS_UNIQ))
    for i, payload in enumerate(new_payloads):
        nid = ref.create_node("Person", name=f"x{i}", photo=payload)
        assert port.create_node("Person", name=f"x{i}", photo=payload) == nid
        bid = ref.shards[ref.owner_of(nid)].graph.store.node_props.get(
            nid, "photo")
        ref.index_insert("face", bid)
        port.index_insert("face", bid)
        owner = port._blob_owner[bid]
        assert owner == ref._blob_owner[bid]
        piece = port.shards[owner].indexes["face"]
        assert bid in piece.to_state()["pend_ids"]
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    nprobe = ref.index_pieces("face")[0].centroids.shape[0]
    assert_knn_same(ref.knn("face", q, 8, nprobe=nprobe),
                    port.knn("face", q, 8, nprobe=nprobe))
    rows = ref.query(SEM_Q, {"src": new_payloads[0]})
    assert rows and port.query(SEM_Q, {"src": new_payloads[0]}) == rows
    ref.close()
    port.close()


def test_knn_fused_mode_passthrough():
    """mode="fused" rides the coordinator path end to end and stays
    identical to the staged ADC scan and to the reference."""
    out = []
    for side in SIDES:
        cfg = side.cfg.VectorIndexConfig(dim=DIM, metric="l2",
                                         vectors_per_bucket=16,
                                         min_buckets=4, nprobe=4, pq_m=8,
                                         pq_residual=True)
        c = make_cluster(side, 2, payloads=PAYLOADS_UNIQ)
        c.build_index("face", "photo", cfg=cfg)
        q = np.random.default_rng(17).standard_normal((6, DIM)).astype(
            np.float32)
        out.append((c.knn("face", q, 5, mode="adc"),
                    c.knn("face", q, 5, mode="fused")))
        c.close()
    (ref_adc, ref_fused), (adc, fused) = out
    np.testing.assert_array_equal(fused[1], adc[1])
    np.testing.assert_array_equal(fused[0], adc[0])
    assert_knn_same(ref_adc, adc)
    assert_knn_same(ref_fused, fused)


def test_knn_merge_runs_on_cpu_without_launch():
    """A CPU coordinator merges with the plain version: no kernel launch."""
    c = make_cluster(PORT, 2, indexed=True)
    before = merge_ops.launches.n
    c.knn("face", np.ones((3, DIM), np.float32), 4)
    assert merge_ops.launches.n == before
    c.close()


# -- fan-out queries -------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_semantic_filter_parity(singles, n_shards):
    """Fan-out semantic filter (no index): the reference's rows, in the
    single node's global order."""
    rows = singles["plain"][0].query(SEM_Q, {"src": BASE})
    assert rows
    ref, port = both(lambda s: make_cluster(s, n_shards))
    assert ref.query(SEM_Q, {"src": BASE}) == rows
    assert port.query(SEM_Q, {"src": BASE}) == rows
    ref.close()
    port.close()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_semantic_filter_pushdown_parity(singles, n_shards):
    """Per-shard index pushdown: the fan-out union equals the single-node
    pushdown on both packages."""
    rows = singles["indexed"][0].query(SEM_Q, {"src": BASE})
    assert singles["indexed"][1].query(SEM_Q, {"src": BASE}) == rows
    ref, port = both(lambda s: make_cluster(s, n_shards, indexed=True))
    assert ref.query(SEM_Q, {"src": BASE}) == rows
    assert port.query(SEM_Q, {"src": BASE}) == rows
    ref.close()
    port.close()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_point_lookup_routed_parity(n_shards):
    ref, port = both(lambda s: make_cluster(s, n_shards))
    for nid in (0, 11, N_NODES - 1):
        rows = port.query(LOOKUP, {"id": nid})
        assert rows == ref.query(LOOKUP, {"id": nid}) == [{"p.name":
                                                             f"n{nid}"}]
        assert port.owner_of(nid) == ref.owner_of(nid)
    assert port.route_counts == ref.route_counts == {"routed": 3,
                                                     "fanout": 0}
    ref.close()
    port.close()


def test_point_lookup_touches_owner_shard_only():
    port = make_cluster(PORT, 4)
    nid = 11
    owner = port.owner_of(nid)
    before = [dict(sh.stats.counts) for sh in port.shards]
    port.query(LOOKUP, {"id": nid})
    for s, sh in enumerate(port.shards):
        scanned = sh.stats.counts.get("nodebylabelscan", 0) \
            - before[s].get("nodebylabelscan", 0)
        assert (scanned > 0) == (s == owner), (s, owner, scanned)
    port.close()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_limit_parity_and_order(singles, n_shards):
    """Fan-out label scan with LIMIT: the ordered merge restores global
    row order, so prefixes are identical."""
    ref, port = both(lambda s: make_cluster(s, n_shards))
    for n in (1, 7, N_NODES):
        text = f"MATCH (p:Person) RETURN p.name LIMIT {n}"
        rows = singles["plain"][0].query(text)
        assert ref.query(text) == rows
        assert port.query(text) == rows
    ref.close()
    port.close()


def test_limit_early_exit_cancels_phi():
    """LIMIT early exit flows through every shard's pipeline: φ extraction
    stops far short of the corpus, on both packages."""
    for side in SIDES:
        extracted = {"n": 0}
        base_fn = side.aipm.feature_hash_extractor(dim=DIM)

        def counting(raws, base_fn=base_fn, extracted=extracted):
            extracted["n"] += len(raws)
            return base_fn(raws)

        c = _populate(side, side.cluster.ShardedPandaDB(2, **side.dev))
        c.register_extractor("face", counting)
        with c.session(batch_rows=4) as s:
            rows = s.run(SEM_Q + " LIMIT 1", {"src": BASE}).fetchall()
        assert len(rows) == 1
        assert 0 < extracted["n"] < N_NODES // 2, extracted["n"]
        c.close()


def test_create_statement_routed():
    """CREATE through the cluster session: replicated slots, owner payload,
    one leader-WAL statement, ids as on the reference."""
    out = []
    for side in SIDES:
        c = make_cluster(side, 2)
        with c.session() as s:
            s.run("CREATE (a:Person {name: 'zz', rank: 3})")
        rows = c.query("MATCH (p:Person) WHERE p.name='zz' RETURN p")
        nid = rows[0]["p.__self__"]
        owner = c.owner_of(nid)
        for s, sh in enumerate(c.shards):
            assert sh.graph.store.n_nodes == N_NODES + 1
            assert sh.graph.store.is_owned(nid) == (s == owner)
        out.append((rows, owner, [stmt for _, stmt in c.wal.entries]))
        c.close()
    assert out[0] == out[1]
    assert out[1][0] == [{"p.__self__": N_NODES}]


def test_create_node_rejects_blob_handles():
    c = port_cluster.ShardedPandaDB(2, device="cpu")
    blob = c.shards[0].graph.blobs.create_from_source(b"x")
    with pytest.raises(TypeError):
        c.create_node("Person", photo=blob)
    c.close()


# -- edge cases ------------------------------------------------------------------


def test_empty_shard():
    """Shards that own nothing scan nothing and contribute only padding."""
    def everything_to_zero(ids):
        return np.zeros(len(np.asarray(ids)), np.int64)

    ref, port = both(lambda s: make_cluster(s, 3, owner_fn=everything_to_zero,
                                            indexed=True))
    assert len(port.shards[1].graph.store.all_nodes()) == 0
    assert port.shards[1].indexes["face"].n_total == 0
    text = "MATCH (p:Person) RETURN p.name LIMIT 5"
    assert port.query(text) == ref.query(text) == [
        {"p.name": f"n{i}"} for i in range(5)]
    q = np.random.default_rng(2).standard_normal((3, DIM)).astype(np.float32)
    m = port.shards[0].indexes["face"].centroids.shape[0]
    got = port.knn("face", q, 4, nprobe=m)
    assert_knn_same(ref.knn("face", q, 4, nprobe=m), got)
    assert np.all(got[1] >= 0) and np.all(np.isfinite(got[0]))
    ref.close()
    port.close()


def test_skewed_partition_matches_single(singles):
    """All rows hashed to one shard: degenerate but still exact."""
    def skew(ids):
        return np.full(len(np.asarray(ids)), 1, np.int64)

    text = "MATCH (p:Person) WHERE p.rank > 4 RETURN p.name"
    rows = singles["plain"][0].query(text)
    ref, port = both(lambda s: make_cluster(s, 2, owner_fn=skew))
    assert ref.query(text) == rows
    assert port.query(text) == rows
    ref.close()
    port.close()


@pytest.mark.parametrize("text", [
    "MATCH (a:Person)-[:KNOWS]->(b) RETURN b.name",                # remote prop
    "MATCH (a:Person)<-[:KNOWS]-(b) WHERE a.name='n3' RETURN a.name",  # in-edges
])
def test_unsupported_queries_raise(text):
    port = make_cluster(PORT, 2)
    with pytest.raises(port_cluster.ClusterUnsupportedQuery):
        port.query(text)
    with pytest.raises(ref_cluster.ClusterUnsupportedQuery):
        make_cluster(REF, 2).query(text)
    # out-expand returning only the neighbor's id is shard-local: allowed
    assert port.query("MATCH (a:Person)-[:KNOWS]->(b) WHERE a.name='n3' "
                      "RETURN a.name, b") == [{"a.name": "n3",
                                               "b.__self__": 4}]
    port.close()


@pytest.mark.parametrize("text", [
    LOOKUP, "MATCH (p:Person) WHERE p.rank > 2 RETURN p.name LIMIT 3",
    SEM_Q])
def test_explain_route(text):
    """explain(): the same anchor, route, plan and counters.  Costs rest
    on measured extraction and scan times, so only their order is held."""
    ref, port = both(lambda s: make_cluster(s, 4, indexed=True))
    want, got = ref.explain(text), port.explain(text)
    for key in ("anchor", "route", "n_shards", "active_shards",
                "shard_map_epoch", "plan", "plan_cache", "route_counts",
                "counters"):
        assert got[key] == want[key], key
    assert got["route"] == ("routed" if text == LOOKUP else "fanout")
    assert got["routed_cost"] < got["fanout_cost"]
    assert ({k: v["path"] for k, v in got["cascade"]["predicates"].items()}
            == {k: v["path"] for k, v in want["cascade"]["predicates"].items()})
    ref.close()
    port.close()


def test_shared_plan_cache_across_shards():
    c = make_cluster(PORT, 4)
    text = "MATCH (p:Person) WHERE p.rank > $r RETURN p.name"
    with c.session() as s:
        stmt = s.prepare(text)
        stmt.run(r=2).fetchall()
        m0 = c.plan_cache.stats()["misses"]
        stmt.run(r=5).fetchall()
        stmt.run(r=1).fetchall()
    pc = c.plan_cache.stats()
    assert pc["misses"] == m0 and pc["hits"] >= 2
    c.close()


def test_session_close_closes_open_cursors():
    c = make_cluster(PORT, 2)
    with c.session(batch_rows=4) as s:
        cur1 = s.run("MATCH (p:Person) RETURN p.name")
        cur2 = s.run("MATCH (p:Person) WHERE p.rank > 2 RETURN p.name")
        assert cur1.fetchone() is not None and cur2.fetchone() is not None
    assert cur1._closed and cur2._closed
    cur1.close()
    c.close()


# -- the merge schedule ------------------------------------------------------------


def test_scatter_gather_padding_contract_starved_shards():
    """Shards holding FEWER than k rows each (one empty): id=-1 exactly
    where val=-inf, the reference's ids, the exact top-5 of the union."""
    rng = np.random.default_rng(21)
    qs = rng.standard_normal((5, 8)).astype(np.float32)
    rows = rng.standard_normal((5, 8)).astype(np.float32)
    out = []
    for side in SIDES:
        shards = [
            side.vi.flat_shard_view(rows[:2], np.asarray([10, 11]),
                                    **side.dev),
            side.vi.flat_shard_view(rows[2:2], np.asarray([], np.int64),
                                    **side.dev),
            side.vi.flat_shard_view(rows[2:], np.asarray([12, 13, 14]),
                                    **side.dev),
        ]
        out.append(side.vi.scatter_gather_knn(shards, qs, 10))
    assert_knn_same(*out)
    v, i = out[1]
    assert v.shape == (5, 10) and i.shape == (5, 10)
    assert np.array_equal(i == -1, ~np.isfinite(v))
    assert (i[:, 5:] == -1).all() and np.isinf(v[:, 5:]).all()
    s = -((qs[:, None, :] - rows[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(
        i[:, :5], np.arange(10, 15)[np.argsort(-s, axis=1, kind="stable")])


@pytest.mark.parametrize("mode", ["float", "adc"])
def test_distributed_knn(mode):
    """The reference collective schedule over loose shards: float, and ADC
    top-k' + exact re-rank on PQ codes -- the reference's ids, and the
    global float truth's on a clustered corpus.  Float scores take the
    reference test's tolerance: the matmul-identity L2 at |x|^2 ~ 1e3
    keeps ~1e-4 of float32 cancellation noise, summed in another order on
    each side; the ADC re-rank is the same numpy on both."""
    vecs = sift_like_vectors(1200, dim=DIM, n_clusters=12, seed=5)
    cfg = ref_cfg.VectorIndexConfig(dim=DIM, vectors_per_bucket=1200,
                                    min_buckets=1, kmeans_iters=1, pq_m=8,
                                    pq_bits=8, pq_kmeans_iters=3,
                                    rerank_mult=16)
    index = ref_vi.IVFIndex.build(vecs, cfg=cfg, seed=0)
    pq = port_vi.PQCodebook(index.pq.codebooks, metric=index.pq.metric)
    rng = np.random.default_rng(6)
    q = vecs[rng.choice(1200, 5)] + \
        rng.standard_normal((5, DIM)).astype(np.float32) * 0.01
    assign = np.arange(1200) % 4
    shards = [index.vectors[assign == s] for s in range(4)]
    id_shards = [index.ids[assign == s] for s in range(4)]
    codes = [index.codes[assign == s] for s in range(4)]
    kw = dict(mode=mode, code_shards=codes) if mode == "adc" else {}
    ref = ref_vi.distributed_knn(q, shards, id_shards, 8, "l2",
                                 pq=index.pq if kw else None, **kw)
    port = port_vi.distributed_knn(q, shards, id_shards, 8, "l2",
                                   pq=pq if kw else None, device="cpu", **kw)
    assert port[0].shape == (5, 8) and port[1].dtype == torch.int64
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               **(TOL if kw else dict(rtol=1e-4, atol=5e-3)))
    _, truth = ref_vi.scan_topk(jnp.asarray(q), jnp.asarray(index.vectors),
                                jnp.asarray(index.ids), 8, "l2")
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(truth))


def test_merge_topk_matches_reference():
    """The associative merge (the collectives' reduce)."""
    rng = np.random.default_rng(4)
    v = -np.sort(-rng.standard_normal((3, 5, 4)).astype(np.float32), axis=2)
    i = rng.integers(0, 100, (3, 5, 4)).astype(np.int64)
    ref = ref_vi.merge_topk(jnp.asarray(v), jnp.asarray(i), 6)
    port = port_vi.merge_topk(torch.from_numpy(v), torch.from_numpy(i), 6)
    assert_knn_same(ref, tuple(x.numpy() for x in port))


def test_coordinator_records_per_shard_ewmas():
    c = make_cluster(PORT, 2, indexed=True)
    q = np.random.default_rng(0).standard_normal((4, DIM)).astype(np.float32)
    c.knn("face", q, 5)
    assert any(k.startswith("shard") for k in c.stats.speeds)
    assert c.knn_fanout_cost("face", q=4, k=5) > 0
    c.close()


# -- serving ---------------------------------------------------------------------


def test_query_server_over_cluster():
    """QueryServer over a coordinator: the reference's rows per request,
    both routes taken, the shared plan cache hit."""
    requests = [(LOOKUP, {"id": 5}),
                ("MATCH (p:Person) RETURN p.name LIMIT 3", None),
                (SEM_Q, {"src": BASE}), (LOOKUP, {"id": 40})]
    out = []
    for side in SIDES:
        c = make_cluster(side, 2, indexed=True)
        server = side.engine.QueryServer(c, n_workers=2)
        server.start()
        try:
            got = []
            for text, params in requests:
                rows, err = server.submit(text, params=params).get(
                    timeout=120)
                assert err is None, err
                got.append(rows)
        finally:
            server.close()
        counts = server.route_counts()
        out.append((got, counts["routed"], counts["fanout"]))
        if side is PORT:
            assert server.device == c.device == torch.device("cpu")
        c.close()
    assert out[1] == out[0]
    assert out[1][1] == 2 and out[1][2] == 2


def test_cluster_needs_a_device():
    """No card and no device named: the coordinator raises, as PandaDB
    does; nothing drops to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.ShardedPandaDB(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cluster.ReplicatedPandaDB(2, replication=2)
