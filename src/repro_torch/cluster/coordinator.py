"""ShardedPandaDB: the cluster coordinator (paper §VII-A serving layer).

Owns N shard replicas -- each a full
:class:`~repro_torch.core.database.PandaDB` over a hash-partitioned slice
(see :mod:`repro_torch.cluster.partition` for the layout rules), all on the
coordinator's one device (the CUDA card unless the caller passes
``device="cpu"``) -- and routes every statement:

* **kNN** scatter-gathers through the one shared merge schedule
  (:func:`repro_torch.core.vector_index.scatter_gather_knn`): per-shard ADC
  or float scan (each shard's cost model picks, from its own observed
  throughputs), the ``topk_merge`` reduce on the device, shard-padding
  truncation.  Exact re-ranked scores merge exactly, so results are
  byte-identical to a single-node index over the same corpus.
* **point lookups / id-bound MATCHes** route to the owner shard only; the
  cost model's ``choose_shard_route`` prefers the routed plan over the
  (also correct, but P-dispatch) fan-out whenever the predicate pins an
  owner.
* **label / all-node scans** fan out to every shard and stream through an
  ordered merge that restores the global row order and preserves ``LIMIT``
  early exit end-to-end (per-shard caps + merged cap + pipeline close).

Sessions (:class:`ClusterSession`) mirror the driver surface
(``prepare()``/``run()``/cursors) and all shards share ONE plan cache:
parse+optimize runs once per query skeleton for the whole cluster, and any
shard's epoch-invalidation semantics apply unchanged because plans are
db-independent trees.  :class:`~repro_torch.serving.engine.QueryServer`
accepts a ``ShardedPandaDB`` wherever it accepts a ``PandaDB`` and runs on
its ``device``.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.pandadb import PandaDBConfig, VectorIndexConfig
from repro_torch.core import logical_plan as lp
from repro_torch.core.cost_model import StatisticsService, estimate_plan_cost
from repro_torch.core.cypherplus import (
    CreateQuery,
    FuncCall,
    Literal,
    MatchQuery,
    Param,
    parse_query,
    query_params,
)
from repro_torch.core.aipm import proxy_key
from repro_torch.core.database import PandaDB
from repro_torch.core.deadline import Deadline
from repro_torch.core.executor import (
    DEFAULT_BATCH_ROWS,
    ExecutionContext,
    execute_iter,
    execute_iter_tagged,
)
from repro_torch.core.session import (
    Cursor,
    PlanCache,
    RWLock,
    _projection_keys,
    bind_text,
    check_wal_renderable,
    plan_query,
    skeleton_of,
)
from repro_torch.core.vector_index import IVFIndex, scatter_gather_knn
from repro_torch.obs import MetricsRegistry, QueryProfile, Tracer
from repro_torch.obs.trace import Trace
from repro_torch.cluster.partition import ShardMap, make_shard
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.cluster.scatter import (
    ClusterUnsupportedQuery,
    close_streams,
    fanout_anchor,
    id_bound_expr,
    ordered_merge,
    resolve_id,
)
from repro_torch.graphstore.blob import Blob
from repro_torch.graphstore.wal import WriteAheadLog


@dataclasses.dataclass(frozen=True)
class _PendingBlob:
    """Blob content + resolved mime, carried from statement resolution to
    owner-shard registration (so cluster CREATEs keep the same blob
    metadata a single-node apply would record)."""
    content: bytes
    mime: str


# -- shard-side write ops -----------------------------------------------------
#
# Every coordinator write is expressed as a named op applied to one shard
# db.  The base coordinator dispatches directly; the replicated coordinator
# records the same (op, args, kwargs) tuple on the shard's op log (the
# leader-WAL path) and applies it to every live replica, so a revived
# replica replays exactly what it missed.

def _create_node_slot(db: PandaDB, nid: int, label: str,
                      scalar_props: Dict[str, Any],
                      blob_specs: Dict[str, Tuple[int, bytes, str]],
                      owned: bool) -> int:
    """One shard's (or replica's) view of a cluster create_node: the label
    slot always, scalar props + blob payload only on the owner."""
    props: Dict[str, Any] = dict(scalar_props)
    for k, (bid, content, mime) in blob_specs.items():
        props[k] = db.graph.blobs.create(content, mime, blob_id=bid)
    got = db.graph.create_node(label, **props)
    assert got == nid, (got, nid)
    db.graph.store.set_owner(nid, owned)
    return nid


def _adopt_node(db: PandaDB, nid: int, scalar_props: Dict[str, Any],
                blob_specs: Dict[str, Tuple[int, bytes, str]],
                out_edges: List[Tuple[int, str, Dict[str, Any]]]) -> int:
    """Rebalance landing path: the slot already exists everywhere; install
    the shipped property payload + blob content + co-located out-edges and
    take ownership."""
    for k, v in scalar_props.items():
        db.graph.store.node_props.set(nid, k, v)
    for k, (bid, content, mime) in blob_specs.items():
        db.graph.blobs.create(content, mime, blob_id=bid)
        db.graph.store.node_props.set(nid, k, bid, kind="blob")
    for tgt, rel_type, rprops in out_edges:
        db.graph.create_relationship(nid, tgt, rel_type, log=False, **rprops)
    db.graph.store.set_owner(nid, True)
    return nid


def _apply_op(db: PandaDB, op: str, args: tuple, kw: Dict[str, Any]) -> Any:
    if op == "create_node":
        return _create_node_slot(db, *args)
    if op == "create_rel":
        return db.graph.create_relationship(*args, **kw)
    if op == "register_extractor":
        return db.register_extractor(*args, **kw)
    if op == "register_proxy":
        return db.register_proxy(*args, **kw)
    if op == "set_calibration":
        sub_key, es, ps, scores, labels = args
        db.calibrator.set_curve(sub_key, es, ps, scores, labels)
        db.stats.epoch += 1      # cascade path unlocked: re-optimize plans
        return None
    if op == "index_insert":
        return db.index_insert(*args)
    if op == "set_index":
        sub_key, piece = args
        db.indexes[sub_key] = piece.replica_view()
        db.stats.note_index_rebuild(sub_key)
        return db.indexes[sub_key]
    if op == "set_owner":
        nid, owned = args
        db.graph.store.set_owner(nid, owned)
        return None
    if op == "adopt_node":
        return _adopt_node(db, *args)
    if op == "drop_blob":
        db.graph.blobs.delete(args[0])
        return None
    raise ValueError(f"unknown shard op {op!r}")


class ClusterCursor(Cursor):
    """A :class:`~repro_torch.core.session.Cursor` over an already-routed row
    stream (merged fan-out or a single shard's pipeline).  Inherits the
    fetch surface; closing tears the shard pipelines down."""

    def __init__(self, gen, keys: Tuple[str, ...] = (),
                 rwlock: Optional[RWLock] = None, deadline=None,
                 trace: Optional[Trace] = None,
                 profile: Optional[QueryProfile] = None,
                 plan: Optional[lp.PlanOp] = None) -> None:
        super().__init__(None, None, keys=tuple(keys), rwlock=rwlock)
        if gen is not None:
            self._gen = gen
            self._exhausted = False
        self._closed = gen is None
        # the statement's shared budget: surfaces degradations/approximate
        # through the inherited Cursor properties (no ctx on the merge side)
        self._deadline = deadline
        # trace/profile installed after super().__init__ (which would treat
        # the plan-less base cursor as exhausted and finish the trace early)
        self.trace = trace
        self._profile = profile
        self._profile_plan = plan
        if gen is None and trace is not None:
            trace.finish()

    def close(self) -> None:
        """Exception-safe teardown: whatever ``_gen.close()`` does (a shard
        erroring during its φ-cancelling close included), this cursor ends
        up closed and re-closing is a no-op."""
        if self._closed:
            return
        try:
            super().close()
        finally:
            self._closed = True
            self._exhausted = True
            self._buf.clear()


class ClusterPreparedStatement:
    """Parsed once; each ``run()`` re-routes (a ``$id`` binding may move
    the owner shard) but reuses the cluster-shared cached plan."""

    def __init__(self, session: "ClusterSession", text: str) -> None:
        self.session = session
        self.text = text
        self.skeleton = skeleton_of(text)
        self.query = parse_query(text)
        self.param_names = frozenset(query_params(self.query))

    def run(self, parameters: Optional[Dict[str, Any]] = None,
            optimized: bool = True,
            deadline_ms: Optional[float] = None,
            profile: bool = False, **params: Any) -> ClusterCursor:
        return self.session._run_parsed(self.skeleton, self.query,
                                        {**(parameters or {}), **params},
                                        optimized=optimized, text=self.text,
                                        deadline_ms=deadline_ms,
                                        profile=profile)


class ClusterSession:
    """One client's conversation with the cluster; the serving workers'
    handle.  API-compatible with :class:`~repro_torch.core.session.Session` for
    the read/write statement surface (``prepare()``/``run()``/cursors)."""

    def __init__(self, cdb: "ShardedPandaDB",
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 use_cache: bool = True,
                 prefetch_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None) -> None:
        self.cdb = cdb
        self.batch_rows = batch_rows
        self.use_cache = use_cache
        self.prefetch_depth = prefetch_depth
        #: default per-query budget (run(deadline_ms=) overrides;
        #: ClusterConfig.default_deadline_ms backstops both)
        self.deadline_ms = deadline_ms
        self._closed = False
        self._cursors: List[ClusterCursor] = []

    def __enter__(self) -> "ClusterSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Close the session AND every cursor it handed out: an abandoned
        mid-iteration cursor still tears its shard pipelines down (each
        close attempted even if an earlier one raises; first error
        re-raised)."""
        self._closed = True
        cursors, self._cursors = self._cursors, []
        first: Optional[BaseException] = None
        for cur in cursors:
            try:
                cur.close()
            except BaseException as e:  # noqa: BLE001 -- visit every cursor
                if first is None:
                    first = e
        if first is not None:
            raise first

    def _track(self, cur: ClusterCursor) -> ClusterCursor:
        # prune finished cursors so long-lived serving sessions stay O(open)
        self._cursors = [c for c in self._cursors
                         if not (c._closed or c._exhausted)]
        if not cur._closed:
            self._cursors.append(cur)
        return cur

    def prepare(self, text: str) -> ClusterPreparedStatement:
        return ClusterPreparedStatement(self, text)

    def run(self, text: str, parameters: Optional[Dict[str, Any]] = None,
            optimized: bool = True,
            deadline_ms: Optional[float] = None,
            profile: bool = False, trace: Optional[Trace] = None,
            **params: Any) -> ClusterCursor:
        if self._closed:
            raise RuntimeError("session is closed")
        params = {**(parameters or {}), **params}
        return self._run_parsed(skeleton_of(text), parse_query(text), params,
                                optimized=optimized, text=text,
                                deadline_ms=deadline_ms,
                                profile=profile, trace=trace)

    def _run_parsed(self, skeleton: str, q, params: Dict[str, Any],
                    optimized: bool, text: str,
                    deadline_ms: Optional[float] = None,
                    profile: bool = False,
                    trace: Optional[Trace] = None) -> ClusterCursor:
        if self._closed:
            raise RuntimeError("session is closed")
        cdb = self.cdb
        missing = query_params(q) - set(params)
        if missing:
            raise KeyError(f"unbound parameters: "
                           f"{', '.join('$' + m for m in sorted(missing))}")
        profile = profile or bool(getattr(q, "profile", False))
        if trace is None:
            trace = cdb.tracer.begin("query", force=profile,
                                     skeleton=skeleton)
        # ONE Deadline object for the whole statement: every shard leg,
        # hedge race and retry below clamps to the same remaining budget
        deadline = Deadline.resolve(deadline_ms, self.deadline_ms,
                                    cdb.cfg.cluster.default_deadline_ms)
        if isinstance(q, CreateQuery):
            cdb.rwlock.acquire_write()
            try:
                cdb._execute_create(q, text, params)
            finally:
                cdb.rwlock.release_write()
            return ClusterCursor(None, trace=trace)
        if trace is None:
            plan = cdb._plan_cached(skeleton, q, optimized,
                                    use_cache=self.use_cache)
        else:
            with trace.span("plan") as sp:
                misses0 = cdb.plan_cache.misses
                plan = cdb._plan_cached(skeleton, q, optimized,
                                        use_cache=self.use_cache)
                sp.set(cache="off" if not self.use_cache else
                       "miss" if cdb.plan_cache.misses > misses0 else "hit")
        qprof: Optional[QueryProfile] = None
        if profile:
            qprof = QueryProfile()
            qprof.capture_predictions(plan, cdb.lead_db().stats)
        route, owner, anchor = cdb._route(q, plan, params)
        if trace is not None:
            trace.event("route", choice=route, anchor=anchor,
                        owner=-1 if owner is None else owner)
        keys = _projection_keys(q)
        if route == "routed":
            if qprof is not None:
                qprof.note_shard(owner)
            ctx = ExecutionContext(cdb.read_db(owner), params,
                                   prefetch_depth=self.prefetch_depth,
                                   deadline=deadline,
                                   trace=trace, profile=qprof)
            return self._track(
                ClusterCursor(execute_iter(plan, ctx, self.batch_rows),
                              keys=keys, rwlock=cdb.rwlock,
                              deadline=deadline, trace=trace,
                              profile=qprof, plan=plan))
        limit = _root_limit(plan, params)
        streams: List[Any] = []
        try:
            for s in cdb.active:
                streams.append(cdb._shard_stream(
                    plan, s, params, anchor, self.batch_rows, limit,
                    self.prefetch_depth, deadline=deadline,
                    trace=trace, profile=qprof))
        except BaseException:
            # a later shard failing to open must not leak the earlier
            # shards' pipelines
            close_streams(streams)
            raise
        gen = ordered_merge(streams,
                            batch_rows=cdb.cfg.cluster.merge_batch_rows,
                            limit=limit)
        return self._track(ClusterCursor(gen, keys=keys, rwlock=cdb.rwlock,
                                         deadline=deadline, trace=trace,
                                         profile=qprof, plan=plan))

    def explain(self, text: str) -> Dict[str, Any]:
        return self.cdb.explain(text)


def _root_limit(plan: lp.PlanOp, params: Dict[str, Any]) -> Optional[int]:
    if not isinstance(plan, lp.Limit):
        return None
    n = plan.n
    if isinstance(n, Param):
        n = params[n.name]
    return int(n)


class ShardedPandaDB:
    """Coordinator over ``n_shards`` hash-partitioned PandaDB replicas, all
    on ``device`` (default: the CUDA card; without one it raises unless
    given ``device="cpu"``)."""

    def __init__(self, n_shards: Optional[int] = None,
                 cfg: Optional[PandaDBConfig] = None,
                 owner_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg or PandaDBConfig()
        #: where every shard's db and index pieces live and scan
        self.device = resolve_device(device)
        self.n_shards = int(n_shards or self.cfg.cluster.n_shards)
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        #: the versioned node->shard assignment; its epoch joins the plan
        #: cache key so topology changes invalidate cached plans
        self.shard_map = ShardMap(self.n_shards, owner_fn)
        self.owner_fn = self.shard_map.owner
        self.shards: List[PandaDB] = self._make_shards()
        #: ONE plan cache for the whole cluster: any worker's prepared
        #: skeleton serves every shard (plans are db-independent trees)
        self.plan_cache = PlanCache()
        for sh in self.shards:
            sh.plan_cache = self.plan_cache
        #: coordinator statistics: per-shard scan EWMAs + fan-out terms
        self.stats = StatisticsService(self.cfg.cost)
        self.rwlock = RWLock()
        self.wal = WriteAheadLog(None)    # leader statement log (§VII-A)
        self._blob_owner: Dict[int, int] = {}
        self._next_blob_id = 0
        #: unified registry: routing decisions, failure-masking counters and
        #: per-node replica reads all live here; ``route_counts`` /
        #: ``cluster_counters()`` below are byte-compatible read views
        self.metrics = MetricsRegistry("cluster")
        for name in ("hedges_fired", "hedges_won", "retries", "failovers",
                     "rebalance_moves", "teardown_errors", "degraded"):
            self.metrics.counter(name)
        self.metrics.counter("route_routed")
        self.metrics.counter("route_fanout")
        self.tracer = Tracer(enabled=self.cfg.obs.trace,
                             keep_last=self.cfg.obs.trace_keep_last)
        self._pool: Optional[ThreadPoolExecutor] = None
        if self.cfg.cluster.parallel_fanout and self.n_shards > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_shards,
                thread_name_prefix="shard-scatter")
        self._default_session: Optional[ClusterSession] = None

    def _make_shards(self) -> List[PandaDB]:
        """One PandaDB per shard; the replicated coordinator overrides this
        to build replica sets and return the primaries."""
        return [make_shard(self.cfg, device=self.device)
                for _ in range(self.n_shards)]

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    @property
    def n_nodes(self) -> int:
        return self.lead_db().graph.store.n_nodes

    @property
    def active(self) -> List[int]:
        """Shard ids currently serving (a recovered-away shard drops out)."""
        return list(self.shard_map.active)

    def owner_of(self, node_id: int) -> int:
        return int(self.owner_fn(np.asarray([node_id], np.int64))[0])

    # -- replica hooks (the replicated coordinator overrides these) -----------

    def read_db(self, s: int) -> PandaDB:
        """The db answering shard ``s``'s reads right now."""
        return self.shards[s]

    def lead_db(self) -> PandaDB:
        """A live db for planning / statistics (any shard works: structure
        and registry serials are replicated)."""
        return self.read_db(self.shard_map.active[0])

    def _shard_apply(self, s: int, op: str, *args: Any, **kw: Any) -> Any:
        """Apply one write op to shard ``s`` (all its live replicas, once
        replicated)."""
        return _apply_op(self.shards[s], op, args, kw)

    def _shard_stream(self, plan: lp.PlanOp, s: int, params: Dict[str, Any],
                      anchor: str, batch_rows: int, limit: Optional[int],
                      prefetch_depth: Optional[int], deadline=None,
                      trace=None, profile=None):
        """One shard's tagged fan-out stream (replicated: hedged +
        failover-wrapped).  ``deadline`` is the statement's shared budget
        (every shard leg clamps to the same remaining time); ``trace`` /
        ``profile`` are the statement's shared span tree and PROFILE
        accumulator (per-node operator times sum across shards because
        every leg executes the same plan tree)."""
        if profile is not None:
            profile.note_shard(s)
        ctx = ExecutionContext(self.shards[s], params,
                               prefetch_depth=prefetch_depth,
                               deadline=deadline,
                               trace=trace, profile=profile)
        return execute_iter_tagged(plan, ctx, anchor, batch_rows,
                                   limit=limit)

    def _count(self, name: str, n: int = 1) -> None:
        self.metrics.counter(name).inc(n)

    def _count_replica_read(self, s: int, r: int) -> None:
        self.metrics.counter(f"replica_reads:s{s}r{r}").inc()

    @property
    def route_counts(self) -> Dict[str, int]:
        """Routed-vs-fanout statement counts (registry-backed; still reads
        like the old plain dict: ``c.route_counts["routed"]``)."""
        return {"routed": self.metrics.counter("route_routed").value,
                "fanout": self.metrics.counter("route_fanout").value}

    def cluster_counters(self) -> Dict[str, int]:
        """Hedges fired/won, retries, failovers, rebalance moves and
        per-node replica reads -- chaos tests assert on these instead of
        timing.  A registry read, shaped exactly like the old counter
        dicts."""
        out: Dict[str, int] = {}
        reads: Dict[str, int] = {}
        for name, v in self.metrics.counters_view().items():
            if name.startswith("route_"):
                continue
            if name.startswith("replica_reads:"):
                reads[name] = v
            else:
                out[name] = v
        for key in sorted(reads):
            out[key] = reads[key]
        return out

    # -- data path (routed writes) --------------------------------------------

    def create_node(self, label: str, **props: Any) -> int:
        """Create one node cluster-wide: the label slot is replicated on
        every shard (structure), properties and blob payload land on the
        owner only.  Blob ids come from the coordinator's global sequence
        so they are identical to a single-node database fed the same
        creation order."""
        nid = self.n_nodes
        owner = self.owner_of(nid)
        scalar: Dict[str, Any] = {}
        blob_specs: Dict[str, Tuple[int, bytes, str]] = {}
        for k, v in props.items():
            if isinstance(v, Blob):
                # a Blob handle points into ONE shard's (or a single-node
                # db's) store; accepting it would leave the content
                # unreachable from the owner and jump the coordinator's
                # global id sequence into the shards' temp range
                raise TypeError(
                    f"property {k!r}: pass blob content (bytes / ndarray), "
                    f"not a Blob handle -- cluster blob ids are assigned by "
                    f"the coordinator")
            if isinstance(v, (bytes, np.ndarray, _PendingBlob)):
                if isinstance(v, _PendingBlob):
                    content, mime = v.content, v.mime
                else:
                    content, mime = \
                        self.lead_db().graph.blobs.resolve_source(v)
                bid = self._next_blob_id
                blob_specs[k] = (bid, content, mime)
                self._blob_owner[bid] = owner
                self._next_blob_id = bid + 1
            else:
                scalar[k] = v
        for s in self.active:
            self._shard_apply(s, "create_node", nid, label,
                              scalar if s == owner else {},
                              blob_specs if s == owner else {},
                              s == owner)
        return nid

    def create_relationship(self, src: int, dst: int, rel_type: str,
                            **props: Any) -> int:
        """Edges are co-located with their source node's shard."""
        return self._shard_apply(self.owner_of(src), "create_rel",
                                 src, dst, rel_type, **props)

    def register_extractor(self, sub_key: str, fn, batch_size: int = 64) -> int:
        """Models are replicated: every shard extracts φ for its own slice
        (and for query-side blobs), so serials stay aligned cluster-wide."""
        serial = 0
        for s in self.active:
            serial = self._shard_apply(s, "register_extractor", sub_key, fn,
                                       batch_size)
        return serial

    def register_proxy(self, sub_key: str, fn, batch_size: int = 256) -> int:
        """Proxy tiers replicate like extractors: every shard scores its own
        slice, so proxy serials (and hence cascade cache/calibration keys)
        stay aligned cluster-wide."""
        serial = 0
        for s in self.active:
            serial = self._shard_apply(s, "register_proxy", sub_key, fn,
                                       batch_size)
        return serial

    def calibrate_cascade(self, sub_key: str, prop_key: str,
                          sample: Optional[int] = None,
                          pairs: Optional[int] = None,
                          seed: Optional[int] = None):
        """Cluster cascade calibration, the ``build_index`` pattern: gather
        every shard's owned blob ids, sort globally (the exact single-node
        sampling input, so the seeded sample -- and therefore the fitted
        curve -- is bit-identical to ``PandaDB.calibrate_cascade`` on the
        same data), extract both tiers on the owner shards, fit ONE curve,
        and install it on every shard via the replayable ``set_calibration``
        op.  Every shard then derives identical thresholds for any target."""
        from repro_torch.core.cascade import curve_from_vectors
        from repro_torch.core.executor import SIM_THRESHOLD

        ccfg = self.cfg.cascade
        sample = ccfg.calibration_sample if sample is None else sample
        pairs = ccfg.calibration_pairs if pairs is None else pairs
        seed = ccfg.calibration_seed if seed is None else seed
        per_bids: Dict[int, np.ndarray] = {}
        column_seen = False
        for s in self.active:
            try:
                per_bids[s] = self.read_db(s).blob_ids_for(prop_key)
                column_seen = True
            except KeyError:
                per_bids[s] = np.empty(0, np.int64)
        if not column_seen:
            raise KeyError(f"no property {prop_key!r}")
        all_bids = np.sort(np.concatenate(list(per_bids.values())))
        if all_bids.size == 0:
            raise ValueError(f"no blobs under property {prop_key!r}")
        rng = np.random.default_rng(seed)
        if len(all_bids) > sample:
            pick = rng.choice(len(all_bids), size=sample, replace=False)
            all_bids = all_bids[np.sort(pick)]
        exact: Dict[int, Any] = {}
        prox: Dict[int, Any] = {}
        for s in self.active:
            sh = self.read_db(s)
            mine = all_bids[np.isin(all_bids, per_bids[s])]
            if mine.size == 0:
                continue
            for b, v in zip(mine, sh.phi_for_blobs(sub_key, mine)):
                exact[int(b)] = v
            for b, v in zip(mine, sh.proxy_for_blobs(sub_key, mine)):
                prox[int(b)] = v
        exact_vecs = np.stack([exact[int(b)] for b in all_bids])
        prox_vecs = np.stack([prox[int(b)] for b in all_bids])
        scores, labels = curve_from_vectors(exact_vecs, prox_vecs, pairs,
                                            seed, SIM_THRESHOLD)
        lead = self.lead_db()
        es = lead.registry.serial(sub_key)
        ps = lead.registry.serial(proxy_key(sub_key))
        for s in self.active:
            self._shard_apply(s, "set_calibration", sub_key, es, ps,
                              scores, labels)
        return lead.calibrator.thresholds(sub_key, es, ps, 0.95)

    # -- indexing ---------------------------------------------------------------

    def build_index(self, sub_key: str, prop_key: str,
                    cfg: Optional[VectorIndexConfig] = None
                    ) -> List[IVFIndex]:
        """Cluster BatchIndexing: each shard extracts φ for its owned blobs,
        the coordinator trains ONE set of centroids + PQ codebooks over the
        gathered space (sorted by blob id -- the exact single-node build
        input, so centroids/codes are bit-identical), then hands every
        shard its owner-assigned bucket contents via ``IVFIndex.shard``."""
        per: List[Tuple[np.ndarray, List[Any], int]] = []
        column_seen = False
        for s in self.active:
            sh = self.read_db(s)
            try:
                bids = sh.blob_ids_for(prop_key)
                column_seen = True
            except KeyError:
                # a shard that owns no node with this property never
                # materialized the column -- it just contributes no rows
                bids = np.empty(0, np.int64)
            vecs = sh.phi_for_blobs(sub_key, bids) if len(bids) else []
            per.append((bids, vecs, s))
        if not column_seen:
            raise KeyError(f"no property {prop_key!r}")
        all_bids = np.concatenate([p[0] for p in per])
        if all_bids.size == 0:
            raise ValueError(f"no blobs under property {prop_key!r}")
        all_vecs = np.stack([v for p in per for v in p[1]])
        order = np.argsort(all_bids, kind="stable")
        all_bids = all_bids[order]
        all_vecs = all_vecs[order]
        serial = self.lead_db().registry.serial(sub_key)
        cfg = cfg or dataclasses.replace(self.cfg.index,
                                         dim=all_vecs.shape[1])
        index = IVFIndex.build(all_vecs, ids=all_bids, cfg=cfg,
                               serial=serial, device=self.device)
        assign = np.asarray([self._blob_owner[int(b)] for b in index.ids],
                            np.int64)
        pieces = index.shard(self.n_shards, assign=assign)
        for s in self.active:
            self._shard_apply(s, "set_index", sub_key, pieces[s])
        self.stats.note_index_rebuild(sub_key)
        return pieces

    def index_insert(self, sub_key: str, blob_id: int) -> None:
        """DynamicIndexing, routed: the blob's owner shard extracts φ (its
        cache/AIPM) and appends to ITS index piece -- membership stays
        consistent with owner-shard routing after any number of inserts."""
        owner = self._blob_owner.get(int(blob_id))
        if owner is None:
            raise KeyError(f"blob {blob_id} was not created through this "
                           f"coordinator")
        self._shard_apply(owner, "index_insert", sub_key, int(blob_id))

    def index_pieces(self, sub_key: str) -> List[IVFIndex]:
        return [self.read_db(s).indexes[sub_key] for s in self.active]

    # -- kNN scatter-gather -----------------------------------------------------

    def knn(self, sub_key: str, queries: np.ndarray, k: int,
            nprobe: Optional[int] = None, mode: str = "auto",
            rerank: bool = True, deadline_ms: Optional[float] = None,
            trace: Optional[Trace] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Scatter-gather kNN over every shard's index piece through the
        shared ``merge_topk`` schedule.  Each shard's scan feeds its own
        cost model (ADC-vs-float stays a per-shard decision) and the
        coordinator's per-shard throughput EWMAs
        (``stats.record_shard_scan``).  Under a ``deadline_ms`` budget,
        shards that cannot answer in time are dropped and the merge
        returns partial top-k from the shards that did (padding contract:
        dropped slots are id=-1 / -inf)."""
        deadline = Deadline.resolve(deadline_ms)
        own_trace = trace is None and self.tracer.enabled
        if own_trace:
            trace = self.tracer.begin("knn", sub_key=sub_key, k=k)
        try:
            vals, ids = scatter_gather_knn(
                self.index_pieces(sub_key), queries, k, nprobe=nprobe,
                mode=mode, rerank=rerank,
                stats=[self.read_db(s).stats for s in self.active],
                record=self.stats.record_shard_scan,
                pool=self._pool,
                split_rerank_budget=self.cfg.cluster.split_rerank_budget,
                deadline=deadline, trace=trace)
        finally:
            if own_trace and trace is not None:
                trace.finish()
        if deadline is not None and "partial_topk" in deadline.degradations:
            self._count("degraded")
        return vals, ids

    def knn_fanout_cost(self, sub_key: str, q: int = 1, k: int = 10,
                        nprobe: Optional[int] = None) -> float:
        pieces = self.index_pieces(sub_key)
        m = pieces[0].centroids.shape[0]
        return self.stats.shard_knn_fanout_cost(
            [p.n_total for p in pieces], m,
            nprobe or pieces[0].cfg.nprobe, q=q, k=k)

    # -- query path -------------------------------------------------------------

    def session(self, batch_rows: Optional[int] = None,
                use_cache: bool = True,
                prefetch_depth: Optional[int] = None,
                deadline_ms: Optional[float] = None) -> ClusterSession:
        kwargs: Dict[str, Any] = {"use_cache": use_cache,
                                  "prefetch_depth": prefetch_depth,
                                  "deadline_ms": deadline_ms}
        if batch_rows is not None:
            kwargs["batch_rows"] = batch_rows
        return ClusterSession(self, **kwargs)

    def query(self, text: str, parameters: Optional[Dict[str, Any]] = None,
              optimized: bool = True, **params: Any) -> List[Dict[str, Any]]:
        if isinstance(parameters, bool):
            parameters, optimized = None, parameters
        if self._default_session is None:
            self._default_session = self.session()
        return self._default_session.run(text, parameters,
                                         optimized=optimized,
                                         **params).fetchall()

    def explain(self, text: str) -> Dict[str, Any]:
        """Route decision + costs the coordinator would use for ``text``."""
        q = parse_query(text)
        if not isinstance(q, MatchQuery):
            raise TypeError("explain() expects a MATCH query")
        plan = self._plan_cached(skeleton_of(text), q, optimized=True)
        anchor = fanout_anchor(plan)
        routable = id_bound_expr(q, anchor) is not None
        n_active = len(self.active)
        cost = estimate_plan_cost(plan, self.lead_db().stats)
        return {
            "anchor": anchor,
            "route": self.stats.choose_shard_route(cost, n_active,
                                                   routable),
            "routed_cost": self.stats.shard_routed_cost(cost, n_active),
            "fanout_cost": self.stats.shard_fanout_cost(cost, n_active),
            "n_shards": self.n_shards,
            "active_shards": self.active,
            "shard_map_epoch": self.shard_map.epoch,
            "plan": plan.describe(),
            "plan_cache": self.plan_cache.stats(),
            "route_counts": dict(self.route_counts),
            "counters": self.cluster_counters(),
            "cascade": self.lead_db()._explain_cascade(plan),
        }

    # -- internals --------------------------------------------------------------

    def _plan_cached(self, skeleton: str, q: MatchQuery, optimized: bool,
                     use_cache: bool = True) -> lp.PlanOp:
        lead = self.lead_db()
        lead.stats.refresh_from_graph(lead.graph)
        lead.stats.refresh_extractor_stats(lead.registry)
        if not use_cache:
            return plan_query(lead, q, optimized)
        # shard_map.epoch in the key: a rebalance/retire invalidates every
        # cached plan (routing decisions bake in the topology)
        key = (skeleton, optimized, lead.stats.epoch, self.shard_map.epoch)
        _, plan = self.plan_cache.get_or_build(
            key, lambda: (q, plan_query(lead, q, optimized)))
        return plan

    def _route(self, q: MatchQuery, plan: lp.PlanOp,
               params: Dict[str, Any]) -> Tuple[str, Optional[int], str]:
        """(route, owner shard or None, anchor var).  Correctness first:
        the anchor check gates everything; the cost model then prefers the
        routed plan over the fan-out whenever the statement pins an owner
        (both are semantically valid -- non-owners would scan their slice
        and match nothing)."""
        anchor = fanout_anchor(plan)
        bound = id_bound_expr(q, anchor)
        cost = estimate_plan_cost(plan, self.lead_db().stats)
        choice = self.stats.choose_shard_route(cost, len(self.active),
                                               routable=bound is not None)
        self.metrics.counter(f"route_{choice}").inc()
        if choice == "routed":
            return "routed", self.owner_of(resolve_id(bound, params)), anchor
        return "fanout", None, anchor

    def _execute_create(self, q: CreateQuery, text: str,
                        params: Dict[str, Any]) -> None:
        """Cluster CREATE: same two-phase contract as
        ``PandaDB._execute_create`` (resolve everything, then apply), with
        node creation routed through :meth:`create_node` so slots replicate
        and payload lands on owners.  The bound statement is logged once on
        the coordinator's leader WAL."""
        params = params or {}
        check_wal_renderable(q, params)

        def resolve(v: Any) -> Any:
            if isinstance(v, Literal):
                return v.value
            if isinstance(v, Param):
                if v.name not in params:
                    raise KeyError(f"missing query parameter ${v.name}")
                return params[v.name]
            return v

        # phase 1: resolve every new node's props (blob sources read here,
        # registered only on apply) -- failures abort before any mutation
        resolved: List[List[Optional[Dict[str, Any]]]] = []
        seen_vars: set = set()
        for pat in q.patterns:
            plist: List[Optional[Dict[str, Any]]] = []
            for np_ in pat.nodes:
                if np_.var in seen_vars:
                    plist.append(None)
                    continue
                if np_.var:
                    seen_vars.add(np_.var)
                props: Dict[str, Any] = {}
                for k, v in np_.props:
                    if isinstance(v, (Literal, Param)):
                        props[k] = resolve(v)
                    elif isinstance(v, FuncCall) \
                            and v.name == "createFromSource":
                        src = resolve(v.args[0])
                        content, mime = \
                            self.lead_db().graph.blobs.resolve_source(
                                src if isinstance(src, (str, bytes))
                                else str(src))
                        # registered on the owner at apply, mime intact
                        props[k] = _PendingBlob(content, mime)
                plist.append(props)
            resolved.append(plist)

        # phase 2: apply (routed), then log once
        env: Dict[str, int] = {}
        for pat, plist in zip(q.patterns, resolved):
            prev = None
            for i, np_ in enumerate(pat.nodes):
                if np_.var in env:
                    nid = env[np_.var]
                else:
                    nid = self.create_node(np_.label or "Node",
                                           **(plist[i] or {}))
                    if np_.var:
                        env[np_.var] = nid
                if prev is not None:
                    rel = pat.rels[i - 1]
                    src, dst = ((prev, nid) if rel.direction != "in"
                                else (nid, prev))
                    self.create_relationship(src, dst, rel.rel_type or "REL")
                prev = nid
        self.wal.append(bind_text(text, params))
