"""Two-sided replication tests: ``repro_torch.cluster.ReplicatedPandaDB``
against ``repro.cluster.ReplicatedPandaDB`` under the same seeded faults.

Each scenario of tests/test_replication.py runs on both packages (72 nodes,
32-d faces; the port with ``device="cpu"``): rows, row order, kNN ids and
the failure-masking counters must be identical, and kNN scores agree within
rtol=atol=1e-5 (float32 sums in another order).  Nothing here rests on a
wall-clock sleep: a slow replica is one whose fault gate blocks on an event
the test sets, so which leg wins a hedge race is decided by the test, not
by the scheduler.  Time-outs on those waits only guard against a hang.
"""
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

import repro.cluster as ref_cluster
import repro.cluster.replication as ref_repl
import repro.configs.pandadb as ref_cfg
import repro.core as ref_core
import repro.core.aipm as ref_aipm
import repro.serving.engine as ref_engine
import repro_torch.cluster as port_cluster
import repro_torch.cluster.replication as port_repl
import repro_torch.configs.pandadb as port_cfg
import repro_torch.core as port_core
import repro_torch.core.aipm as port_aipm
import repro_torch.serving.engine as port_engine

# the suite runs in several workers at once: a torch process here keeps
# to one intra-op thread, so that the timing-driven tests beside it (the
# replica choice in tests/test_overload.py) are not starved of cores
torch.set_num_threads(1)

N_NODES = 72
DIM = 32
TOL = dict(rtol=1e-5, atol=1e-5)
HANG = 60.0      # bound on every wait: reached only if something hangs

REF = types.SimpleNamespace(core=ref_core, aipm=ref_aipm, cluster=ref_cluster,
                            repl=ref_repl, cfg=ref_cfg, engine=ref_engine,
                            dev={})
PORT = types.SimpleNamespace(core=port_core, aipm=port_aipm,
                             cluster=port_cluster, repl=port_repl,
                             cfg=port_cfg, engine=port_engine,
                             dev={"device": "cpu"})
SIDES = (REF, PORT)

#: all-distinct photos: kNN parity needs no exact score ties
_RNG = np.random.default_rng(4)
PAYLOADS = [_RNG.bytes(256) for _ in range(N_NODES)]

SCAN_Q = "MATCH (p:Person) WHERE p.rank > 1 RETURN p.name, p.rank"
LOOKUP = "MATCH (p:Person) WHERE p = $id RETURN p.name"
QUERIES = np.random.default_rng(9).standard_normal((4, DIM)).astype(
    np.float32)

#: counters whose values do not depend on thread timing when hedging is off
COUNTERS = ("hedges_fired", "hedges_won", "retries", "failovers",
            "rebalance_moves", "teardown_errors", "degraded")


def _populate(side, db):
    db.register_extractor("face", side.aipm.feature_hash_extractor(dim=DIM))
    clustered = isinstance(db, side.cluster.ShardedPandaDB)
    cn = db.create_node if clustered else db.graph.create_node
    cr = db.create_relationship if clustered else db.graph.create_relationship
    nodes = [cn("Person", name=f"n{i}", rank=float(i % 7),
                photo=PAYLOADS[i]) for i in range(N_NODES)]
    for i in range(N_NODES - 1):
        cr(nodes[i], nodes[i + 1], "KNOWS")
    return db


class GatedFaults:
    """A FaultInjector whose listed (shard, replica) gates block until the
    test opens them: a slow replica without a clock."""

    def __init__(self, side, seed=0):
        self.inner = side.cluster.FaultInjector(seed=seed)
        self.gates = {}

    def hold(self, shard, replica):
        self.gates[(shard, replica)] = threading.Event()

    def release(self):
        for gate in self.gates.values():
            gate.set()

    def check(self, shard, replica):
        gate = self.gates.get((shard, replica))
        if gate is not None:
            assert gate.wait(HANG), "gate never opened"
        self.inner.check(shard, replica)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def make_replicated(side, n_shards=2, replication=2, seed=0, hedge=True,
                    indexed=True, merge_rows=None, faults=None, owner_fn=None):
    faults = faults or side.cluster.FaultInjector(seed=seed)
    cfg = side.cfg.PandaDBConfig()
    cluster = dataclasses.replace(cfg.cluster, hedge_reads=hedge)
    if merge_rows is not None:
        cluster = dataclasses.replace(cluster, merge_batch_rows=merge_rows)
    cfg = dataclasses.replace(cfg, cluster=cluster)
    c = _populate(side, side.cluster.ReplicatedPandaDB(
        n_shards=n_shards, cfg=cfg, replication=replication, faults=faults,
        owner_fn=owner_fn, **side.dev))
    if indexed:
        c.build_index("face", "photo")
    return c, faults


def knn_full(c, k=6):
    """Full-probe kNN (parity needs the same probe set everywhere)."""
    nprobe = max(p.centroids.shape[0] for p in c.index_pieces("face"))
    return c.knn("face", QUERIES, k, nprobe=nprobe)


def assert_knn_same(ref, port):
    rv, ri = (np.asarray(x) for x in ref)
    pv, pi = (np.asarray(x) for x in port)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, **TOL)


def counters(c):
    got = c.cluster_counters()
    return {k: got[k] for k in COUNTERS}


@pytest.fixture(scope="module")
def single():
    db = _populate(REF, ref_core.PandaDB())
    db.build_index("face", "photo")
    return db


def run_both(scenario):
    """scenario(side) -> comparable outcome, on both packages."""
    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    return port


# -- healthy parity --------------------------------------------------------------


@pytest.mark.parametrize("replication", [1, 2, 3])
def test_replicated_healthy_parity(single, replication):
    """R replicas change nothing: scans, routed lookups, kNN identical to
    one reference node."""
    want = single.query(SCAN_Q)
    index = single.indexes["face"]
    v_s, i_s = index.search_many(QUERIES, 6, nprobe=index.centroids.shape[0])
    c, _ = make_replicated(PORT, replication=replication, hedge=False)
    assert c.query(SCAN_Q) == want
    assert c.query(LOOKUP, {"id": 7}) == [{"p.name": "n7"}]
    assert_knn_same((v_s, i_s), knn_full(c))
    c.close()


def test_replicas_share_index_tables():
    """Every replica of a shard holds its own piece object, over one set of
    device tables: the index is uploaded once per shard, not per replica;
    an insert on one replica stays in that replica's append buffers."""
    c, _ = make_replicated(PORT, replication=3, hedge=False)
    for rs in c.replica_sets:
        pieces = [db.indexes["face"] for db in rs.replicas]
        assert len({id(p) for p in pieces}) == 3
        assert all(p.t_vectors is pieces[0].t_vectors for p in pieces)
        assert all(p.vectors is pieces[0].vectors for p in pieces)
    nid = c.create_node("Person", name="late",
                        photo=np.random.default_rng(1).bytes(256))
    bid = int(max(c._blob_owner))
    c.index_insert("face", bid)
    owner = c._blob_owner[bid]
    for db in c.replica_sets[owner].replicas:
        assert db.indexes["face"].pending_count == 1
    assert nid == N_NODES
    c.close()


# -- fail-stop + failover --------------------------------------------------------


@pytest.mark.chaos
def test_kill_replica_mid_scan(single):
    """Fail-stop the serving replicas while a fan-out scan is half
    consumed: the streams fail over, fast-forward, and the result equals
    the healthy one; the counters match the reference's."""
    want = single.query(SCAN_Q)

    def scenario(side):
        c, faults = make_replicated(side, hedge=False, merge_rows=4)
        with c.session(batch_rows=8) as s:
            cur = s.run(SCAN_Q)
            head = [cur.fetchone() for _ in range(5)]
            faults.fail_stop(0, 0)
            faults.fail_stop(1, 0)
            rows = head + cur.fetchall()
        after = c.query(SCAN_Q)
        out = (rows, after, counters(c))
        c.close()
        return out

    rows, after, got = run_both(scenario)
    assert rows == after == want
    assert got["failovers"] >= 1


@pytest.mark.chaos
def test_kill_replica_mid_knn(single):
    def scenario(side):
        c, faults = make_replicated(side, hedge=False)
        before = knn_full(c)
        faults.fail_stop(0, 0)
        after = knn_full(c)
        out = (before, after, counters(c))
        c.close()
        return out

    ref, port = scenario(REF), scenario(PORT)
    for a, b in zip(ref[:2], port[:2]):
        assert_knn_same(a, b)
    np.testing.assert_array_equal(port[0][1], port[1][1])
    np.testing.assert_array_equal(port[0][0], port[1][0])
    assert port[2] == ref[2] and port[2]["failovers"] >= 1


@pytest.mark.chaos
def test_all_replicas_dead_raises():
    for side in SIDES:
        c, faults = make_replicated(side, hedge=False)
        faults.fail_stop(0, 0)
        faults.fail_stop(0, 1)
        with pytest.raises(side.cluster.ReplicaDown):
            c.query(SCAN_Q)
        c.close()


@pytest.mark.chaos
def test_transient_error_retried(single):
    want = single.query(SCAN_Q)

    def scenario(side):
        c, faults = make_replicated(side, hedge=False)
        faults.error_on_call(0, 0, times=1)
        out = (c.query(SCAN_Q), counters(c),
               list(c.replica_sets[0].alive))
        c.close()
        return out

    rows, got, alive = run_both(scenario)
    assert rows == want and got["retries"] >= 1 and alive == [True, True]


# -- hedged reads ------------------------------------------------------------------


@pytest.mark.chaos
@pytest.mark.parametrize("what", ["scan", "knn"])
def test_hedged_read_masks_slow_replica(single, what):
    """The preferred replica of shard 0 blocks until the statement is
    answered; a zero hedge deadline makes the backup race it at once and
    win.  Results stay identical; the hedge is counted."""
    def scenario(side):
        faults = GatedFaults(side)
        c, _ = make_replicated(side, hedge=True, faults=faults)
        c.stats.hedge_deadline = lambda shard: 0.0
        faults.hold(0, 0)
        try:
            out = (c.query(SCAN_Q) if what == "scan"
                   else tuple(np.asarray(x).tolist() for x in knn_full(c)))
            got = counters(c)
        finally:
            faults.release()
        c.close()
        return out, got["hedges_fired"] >= 1, got["hedges_won"] >= 1

    ref, port = scenario(REF), scenario(PORT)
    assert port[1:] == ref[1:] == (True, True)
    if what == "scan":
        assert port[0] == ref[0] == single.query(SCAN_Q)
    else:
        assert_knn_same(ref[0], port[0])


@pytest.mark.chaos
def test_close_drains_running_hedges(single):
    """A hedge leg still blocked on its replica when close() lands: close
    cancels queued legs and DRAINS the running one instead of abandoning
    it; the leg finishes, nothing is counted as a teardown error, and a
    second close is a no-op."""
    def scenario(side):
        faults = GatedFaults(side)
        c, _ = make_replicated(side, hedge=True, faults=faults)
        c.stats.hedge_deadline = lambda shard: 0.0
        faults.hold(0, 0)
        faults.hold(1, 0)
        result = knn_full(c)
        with c._hedge_lock:
            legs = list(c._hedge_inflight)
        assert legs and not all(fu.done() for fu in legs)
        draining = threading.Event()
        real_wait = side.repl.wait

        def watched_wait(fs, timeout=None, **kw):
            draining.set()
            return real_wait(fs, timeout=timeout, **kw)

        side.repl.wait = watched_wait
        try:
            closer = threading.Thread(target=c.close)
            closer.start()
            assert draining.wait(HANG)
            assert closer.is_alive()         # blocked on the running legs
            faults.release()
            closer.join(HANG)
            assert not closer.is_alive()
        finally:
            side.repl.wait = real_wait
            faults.release()
        with c._hedge_lock:
            assert all(fu.done() for fu in c._hedge_inflight)
        assert c._hedge_pool is None
        c.close()
        got = counters(c)
        return (tuple(np.asarray(x).tolist() for x in result),
                got["hedges_fired"] >= 1, got["teardown_errors"])

    ref, port = scenario(REF), scenario(PORT)
    assert_knn_same(ref[0], port[0])
    assert port[1:] == ref[1:] == (True, 0)


@pytest.mark.chaos
def test_hedge_after_close_is_inert(single):
    """kNN after close(): no hedge pool, reads run on the calling thread."""
    c, _ = make_replicated(PORT)
    c.close()
    index = single.indexes["face"]
    assert_knn_same(index.search_many(QUERIES, 6,
                                      nprobe=index.centroids.shape[0]),
                    knn_full(c))
    assert c.cluster_counters()["hedges_fired"] == 0


def test_hedge_deadline_and_replica_choice():
    c, _ = make_replicated(PORT, indexed=False)
    cost, stats = c.cfg.cost, c.stats
    assert stats.hedge_deadline(3) == cost.hedge_floor_s
    for lat in (0.010, 0.012, 0.014, 0.016):
        stats.record_replica_read(3, 0, lat)
    assert stats.hedge_deadline(3) == pytest.approx(
        0.013 * cost.hedge_deadline_mult)
    stats.record_replica_read(0, 0, 0.050)
    stats.record_replica_read(0, 1, 0.001)
    assert stats.choose_replica(0, [0, 1]) == 1
    assert stats.choose_replica(1, [0, 1]) == 0
    c.close()


# -- op-log catch-up (§VII-A rejoin) ---------------------------------------------


@pytest.mark.chaos
def test_replica_catch_up_after_revive():
    """A dead replica misses writes; revive() replays exactly the missed
    ops and the replica rejoins with the reference's rows."""
    def scenario(side):
        c, faults = make_replicated(side, hedge=False)
        rs = c.replica_sets[0]
        v_before = rs.versions[0]
        faults.fail_stop(0, 0)
        c.query(SCAN_Q)
        nid = c.create_node("Person", name="late", rank=6.5)
        c.create_relationship(nid - 1, nid, "KNOWS")
        missed = rs.versions[0] == v_before
        replayed = c.revive(0, 0)
        out = (missed, replayed, rs.oplog.version - v_before,
               rs.versions[0] == rs.oplog.version, rs.alive[0],
               sorted(r["p.name"] for r in c.query(SCAN_Q)))
        c.close()
        return out

    missed, replayed, gap, caught_up, alive, names = run_both(scenario)
    assert missed and replayed == gap and caught_up and alive
    assert "late" in names


# -- rebalancing -------------------------------------------------------------------


def test_rebalance_explicit_moves(single):
    """Moving ownership keeps scan, routed and kNN parity; the shard-map
    epoch bump invalidates cached plans; re-running plans no moves."""
    def scenario(side):
        c, _ = make_replicated(side, hedge=False)
        c.query(SCAN_Q)
        epoch0 = c.shard_map.epoch
        rb = side.cluster.Rebalancer(c)
        target = {0: 1, 1: 1, 12: 0, 13: 0}
        moves = rb.rebalance(target)
        out = ([(m.node_id, m.src, m.dst) for m in moves],
               c.shard_map.epoch - epoch0, counters(c),
               [c.owner_of(n) for n in target], c.query(SCAN_Q),
               c.query(LOOKUP, {"id": 0}),
               tuple(np.asarray(x).tolist() for x in knn_full(c)),
               rb.rebalance(target), c.shard_map.epoch - epoch0)
        c.close()
        return out

    ref, port = scenario(REF), scenario(PORT)
    assert port[:6] == ref[:6] and port[7:] == ref[7:]
    assert_knn_same(ref[6], port[6])
    moves, bump, got, owners, rows, lookup, _, again, bump2 = port
    assert moves and bump == 1 and got["rebalance_moves"] == len(moves)
    assert owners == [1, 1, 0, 0] and again == [] and bump2 == 1
    assert rows == single.query(SCAN_Q)
    assert lookup == [{"p.name": "n0"}]


def test_rebalance_skew_trigger(single):
    """A pathologically skewed owner_fn trips the skew detector; after the
    move the spread tightens and parity holds."""
    def scenario(side):
        c, _ = make_replicated(
            side, hedge=False, indexed=False, seed=2,
            owner_fn=lambda ids: np.zeros(len(ids), np.int64))
        rb = side.cluster.Rebalancer(c)
        before = rb.owned_counts()
        target = rb.skew_targets()
        rb.rebalance(target)
        out = (before, sorted(target.items()), rb.owned_counts(),
               c.query(SCAN_Q), rb.skew_targets())
        c.close()
        return out

    before, target, after, rows, again = run_both(scenario)
    assert before == {0: N_NODES, 1: 0}
    assert target and {d for _, d in target} == {1}
    assert after[1] > 0 and sum(after.values()) == N_NODES
    assert rows == single.query(SCAN_Q) and again == {}


@pytest.mark.chaos
def test_dead_shard_recovery(single):
    """Shard 1 loses a replica for good: recovery spreads its rows over the
    survivors and retires it; scans, lookups, kNN and later writes keep
    the reference's results at the new topology."""
    def scenario(side):
        c, faults = make_replicated(side, n_shards=3, hedge=False)
        c.query(SCAN_Q)
        epoch0 = c.shard_map.epoch
        faults.fail_stop(1, 0)
        rb = side.cluster.Rebalancer(c)
        target = rb.recovery_targets(1)
        moves = rb.rebalance(target, retire=1)
        nid = c.create_node("Person", name="post", rank=1.0)
        out = (sorted(target.items()), len(moves), c.active,
               c.shard_map.epoch - epoch0, c.query(SCAN_Q),
               c.query(LOOKUP, {"id": 10}),
               tuple(np.asarray(x).tolist() for x in knn_full(c)),
               c.owner_of(nid), c.query(LOOKUP, {"id": nid}))
        c.close()
        return out

    ref, port = scenario(REF), scenario(PORT)
    assert port[:6] == ref[:6] and port[7:] == ref[7:]
    assert_knn_same(ref[6], port[6])
    index = single.indexes["face"]
    assert_knn_same(index.search_many(QUERIES, 6,
                                      nprobe=index.centroids.shape[0]),
                    port[6])
    target, n_moves, active, bump, rows, lookup, _, owner, post = port
    assert n_moves == len(target) and active == [0, 2] and bump >= 2
    assert rows == single.query(SCAN_Q) and lookup == [{"p.name": "n10"}]
    assert owner in (0, 2) and post == [{"p.name": "post"}]


# -- serving under chaos -----------------------------------------------------------


@pytest.mark.chaos
def test_query_server_survives_replica_kill(single):
    """A QueryServer keeps serving through a replica fail-stop landed
    between requests: no request fails, every answer equals the healthy
    one, and the failover shows in the serving counters."""
    want = single.query(SCAN_Q)
    requests = [(SCAN_Q, None), (LOOKUP, {"id": 5})] * 4

    def scenario(side):
        c, faults = make_replicated(side, hedge=False)
        server = side.engine.QueryServer(c, n_workers=2)
        server.start()
        answers = []
        try:
            for n, (text, params) in enumerate(requests):
                if n == len(requests) // 2:
                    faults.fail_stop(0, 0)
                rows, err = server.submit(text, params=params).get(
                    timeout=HANG)
                assert err is None, err
                answers.append(rows)
        finally:
            server.close()
        counts = server.route_counts()
        out = (answers, c.replica_sets[0].alive[0], counts["failovers"],
               counts.get("serve_failed", 0), c.query(SCAN_Q))
        c.close()
        return out

    answers, alive, failovers, failed, after = run_both(scenario)
    assert answers[::2] == [want] * 4 and after == want
    assert answers[1] == [{"p.name": "n5"}]
    assert not alive and failovers >= 1 and failed == 0


# -- loser teardown ----------------------------------------------------------------


def test_loser_reaper_narrowed_exceptions():
    """Expected close/cancel noise is swallowed, a ReplicaDown loser folds
    into failovers, anything else counts as a teardown error."""
    from concurrent.futures import Future

    def scenario(side):
        c, _ = make_replicated(side, indexed=False)
        base = counters(c)
        reap = side.repl._loser_reaper
        fu = Future()
        fu.cancel()
        reap(c, 0, 1, None)(fu)
        fu = Future()
        fu.set_exception(side.repl.ReplicaError("transient"))
        reap(c, 0, 1, None)(fu)
        quiet = counters(c) == base
        fu = Future()
        fu.set_exception(side.repl.ReplicaDown("gone"))
        reap(c, 0, 1, None)(fu)
        dead = not c.replica_sets[0].alive[1]
        fu = Future()
        fu.set_exception(KeyError("boom"))
        reap(c, 0, 1, None)(fu)
        fu = Future()
        fu.set_result("res")
        reap(c, 0, 1, lambda res: (_ for _ in ()).throw(
            OSError("fd gone")))(fu)
        got = counters(c)
        c.close()
        return (quiet, dead, got["failovers"] - base["failovers"],
                got["teardown_errors"] - base["teardown_errors"])

    assert run_both(scenario) == (True, True, 1, 2)


def test_close_quiet_counts_unexpected():
    class Noisy:
        def __init__(self, exc):
            self.exc = exc

        def close(self):
            raise self.exc

    def scenario(side):
        c, _ = make_replicated(side, indexed=False)
        base = counters(c)["teardown_errors"]
        side.repl._close_quiet(
            Noisy(RuntimeError("generator ignored GeneratorExit")), c)
        side.repl._close_quiet(Noisy(side.repl.ReplicaError("mid-close")), c)
        quiet = counters(c)["teardown_errors"] - base
        side.repl._close_quiet(Noisy(KeyError("boom")), c)
        out = (quiet, c.explain(SCAN_Q)["counters"]["teardown_errors"] - base)
        c.close()
        return out

    assert run_both(scenario) == (0, 1)


def test_replicated_device():
    """Every replica of every shard lives on the coordinator's device."""
    c, _ = make_replicated(PORT, replication=2, indexed=True)
    assert c.device == torch.device("cpu")
    for rs in c.replica_sets:
        for db in rs.replicas:
            assert db.device == c.device
            assert db.indexes["face"].t_vectors.device == c.device
    c.close()
