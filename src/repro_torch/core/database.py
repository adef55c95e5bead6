"""PandaDB facade: one object wiring graph + parser + optimizer + executor +
cache + AIPM + vector indexes (the paper's Fig 2 architecture).  Vector
indexes live on the db's device: the CUDA card unless the caller passes
``device="cpu"``."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.pandadb import PandaDBConfig, VectorIndexConfig
from repro_torch.core import logical_plan as lp
from repro_torch.core.aipm import AIPMService, ModelRegistry, proxy_key
from repro_torch.core.cascade import CascadeCalibrator, curve_from_vectors
from repro_torch.core.cost_model import StatisticsService, estimate_plan_cost
from repro_torch.core.cypherplus import CreateQuery, MatchQuery, parse_query
from repro_torch.core.plan_optimizer import QueryGraph, naive_plan, optimize
from repro_torch.core.property_graph import PandaGraph
from repro_torch.core.semantic_cache import InflightTable, SemanticCache
from repro_torch.core.session import (
    PlanCache,
    RWLock,
    Session,
    bind_text,
    plan_query,
)
from repro_torch.core.vector_index import IVFIndex
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import MetricsRegistry, Tracer


class PandaDB:
    def __init__(self, cfg: Optional[PandaDBConfig] = None,
                 wal_path: Optional[str] = None,
                 device: DeviceLike = None) -> None:
        self.cfg = cfg or PandaDBConfig()
        #: where vector indexes live and scan (None: the CUDA card)
        self.device = resolve_device(device)
        self.tracer = Tracer(enabled=self.cfg.obs.trace,
                             keep_last=self.cfg.obs.trace_keep_last)
        self.metrics = MetricsRegistry("pandadb")
        self.graph = PandaGraph(self.cfg, wal_path)
        self.registry = ModelRegistry()
        self.aipm = AIPMService(self.registry, self.cfg.aipm,
                                metrics=self.metrics)
        self.cache = SemanticCache(self.cfg.cache)
        self.inflight = InflightTable()   # cross-session φ request dedup
        self.stats = StatisticsService(self.cfg.cost)
        self.calibrator = CascadeCalibrator(self.cfg.cascade.min_curve_pairs,
                                            metrics=self.metrics)
        self.indexes: Dict[str, IVFIndex] = {}
        self.scalar_indexes: Dict[str, Any] = {}   # NumericIndex | InvertedIndex
        self.plan_cache = PlanCache()
        self.rwlock = RWLock()          # leader write serialization
        self._default_session: Optional[Session] = None

    # -- driver surface (sessions / prepared statements / cursors) -------------

    def session(self, batch_rows: Optional[int] = None,
                use_cache: bool = True,
                prefetch_depth: Optional[int] = None,
                deadline_ms: Optional[float] = None) -> Session:
        """Open a driver session: ``prepare()``/``run()``/transactions.
        Sessions share this db's plan cache; one session per worker thread.
        ``prefetch_depth`` overrides the AIPMConfig default for how many
        chunks of φ extraction are kept in flight ahead of the semantic
        filter (0 = fully synchronous extraction).  ``deadline_ms`` is the
        session's default per-query budget (run(deadline_ms=) overrides per
        statement; ``ClusterConfig.default_deadline_ms`` backstops both)."""
        kwargs: Dict[str, Any] = {"use_cache": use_cache,
                                  "prefetch_depth": prefetch_depth,
                                  "deadline_ms": deadline_ms}
        if batch_rows is not None:
            kwargs["batch_rows"] = batch_rows
        return Session(self, **kwargs)

    # -- model / φ management (paper §IV-B) -----------------------------------

    def register_extractor(self, sub_key: str,
                           fn: Callable[[List[np.ndarray]], np.ndarray],
                           batch_size: int = 64) -> int:
        """Register/update the AI model for a sub-property.  Updating bumps
        the serial and invalidates stale cache entries + indexes (Fig 6)."""
        spec = self.registry.register(sub_key, fn, batch_size)
        self.graph.declare_sub_property(sub_key)
        dropped = self.cache.invalidate_serial(sub_key, spec.serial)
        idx = self.indexes.get(sub_key)
        if idx is not None and idx.serial != spec.serial:
            del self.indexes[sub_key]     # must be rebuilt (BatchIndexing)
        sidx = self.scalar_indexes.get(sub_key)
        if sidx is not None and sidx.serial != spec.serial:
            del self.scalar_indexes[sub_key]
        # curves pairing the old exact serial describe a retired model
        # (thresholds() already keys on serials; drop frees the memory)
        self.calibrator.drop(sub_key)
        return spec.serial

    def register_proxy(self, sub_key: str,
                       fn: Callable[[List[np.ndarray]], np.ndarray],
                       batch_size: int = 256) -> int:
        """Attach a cheap proxy scorer to ``sub_key``'s extractor (proxy-first
        cascades).  Re-registering bumps the proxy tier's serial, invalidating
        its cache entries and every calibration curve built against it; the
        exact tier is untouched."""
        spec = self.registry.register_proxy(sub_key, fn, batch_size)
        self.cache.invalidate_serial(proxy_key(sub_key), spec.serial)
        self.calibrator.drop(sub_key)
        return spec.serial

    def proxy_for_blobs(self, sub_key: str, blob_ids: np.ndarray) -> List[Any]:
        """Proxy-tier φ for every blob id (cache -> batched AIPM), the
        cheap sibling of :meth:`phi_for_blobs`."""
        return self.phi_for_blobs(proxy_key(sub_key), blob_ids)

    def calibrate_cascade(self, sub_key: str, prop_key: str,
                          sample: Optional[int] = None,
                          pairs: Optional[int] = None,
                          seed: Optional[int] = None):
        """Fit the cascade calibration curve for (``sub_key``'s extractor,
        its proxy) from a seeded sample of ``prop_key`` blobs: extract both
        tiers for the sampled blobs, draw random pairs, score each pair with
        the proxy and label it with the exact φ at the executor's similarity
        threshold.  Returns the fitted :class:`CascadeThresholds` preview at
        a 0.95 target (the curve itself serves *any* target)."""
        from repro_torch.core.executor import SIM_THRESHOLD
        ccfg = self.cfg.cascade
        sample = ccfg.calibration_sample if sample is None else sample
        pairs = ccfg.calibration_pairs if pairs is None else pairs
        seed = ccfg.calibration_seed if seed is None else seed
        blob_ids = self.blob_ids_for(prop_key)
        rng = np.random.default_rng(seed)
        if len(blob_ids) > sample:
            pick = rng.choice(len(blob_ids), size=sample, replace=False)
            blob_ids = blob_ids[np.sort(pick)]
        exact = np.stack(self.phi_for_blobs(sub_key, blob_ids))
        prox = np.stack(self.proxy_for_blobs(sub_key, blob_ids))
        scores, labels = curve_from_vectors(exact, prox, pairs, seed,
                                            SIM_THRESHOLD)
        es = self.registry.serial(sub_key)
        ps = self.registry.serial(proxy_key(sub_key))
        self.calibrator.set_curve(sub_key, es, ps, scores, labels)
        # calibration unlocks the cascade path: cached plans deserve a look
        self.stats.epoch += 1
        return self.calibrator.thresholds(sub_key, es, ps, 0.95)

    # -- indexing (paper §VI-B2) ------------------------------------------------

    def blob_ids_for(self, prop_key: str,
                     node_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Distinct blob ids a property column holds over ``node_ids``
        (default: every node this store owns), sorted ascending."""
        node_ids = (np.asarray(node_ids) if node_ids is not None
                    else self.graph.store.all_nodes())
        col = self.graph.store.node_props.column(prop_key)
        if col is None:
            raise KeyError(f"no property {prop_key!r}")
        blob_ids = np.asarray(col.values, np.int64)[node_ids]
        return np.unique(blob_ids[blob_ids >= 0])

    def phi_for_blobs(self, sub_key: str, blob_ids: np.ndarray) -> List[Any]:
        """φ for every blob id, through cache -> batched AIPM extraction
        (the BatchIndexing inner loop; cluster shards run it over their
        owned slice only)."""
        serial = self.registry.serial(sub_key)
        items = [(int(b), self.graph.blobs.as_array(int(b)))
                 for b in blob_ids
                 if self.cache.get(int(b), sub_key, serial) is None]
        if items:
            for bid, vec in self.aipm.extract_sync(sub_key, items).items():
                self.cache.put(bid, sub_key, serial, vec)
        return [self.cache.get(int(b), sub_key, serial) for b in blob_ids]

    def build_index(self, sub_key: str, prop_key: str,
                    node_ids: Optional[np.ndarray] = None,
                    cfg: Optional[VectorIndexConfig] = None) -> IVFIndex:
        """BatchIndexing: extract φ for every unstructured item, then build
        the IVF index over the semantic space."""
        blob_ids = self.blob_ids_for(prop_key, node_ids)
        serial = self.registry.serial(sub_key)
        vecs = np.stack(self.phi_for_blobs(sub_key, blob_ids))
        # carry every deployment knob (incl. pq_m / pq_bits / rerank_mult:
        # IVF-PQ mode trains codebooks inside IVFIndex.build)
        cfg = cfg or dataclasses.replace(self.cfg.index, dim=vecs.shape[1])
        index = IVFIndex.build(vecs, ids=blob_ids, cfg=cfg, serial=serial,
                               device=self.device)
        self.indexes[sub_key] = index
        # a fresh index changes which plans are optimal (pushdown becomes
        # available): bump the stats epoch so the plan cache re-optimizes
        self.stats.note_index_rebuild(sub_key)
        return index

    def build_scalar_index(self, sub_key: str, prop_key: str):
        """Paper §VI-B2: B-tree-style index for numeric semantic info,
        inverted index for strings/labels.  Type is detected from the
        extracted values."""
        from repro_torch.core.scalar_index import InvertedIndex, NumericIndex
        blob_ids = self.blob_ids_for(prop_key)
        serial = self.registry.serial(sub_key)
        vals = self.phi_for_blobs(sub_key, blob_ids)
        if all(isinstance(v, (int, float, np.integer, np.floating))
               or (isinstance(v, np.ndarray) and v.ndim == 0
                   and np.issubdtype(v.dtype, np.number))
               for v in vals):
            idx = NumericIndex.build([float(v) for v in vals], blob_ids,
                                     serial)
        else:
            idx = InvertedIndex.build([str(v) for v in vals], blob_ids,
                                      serial)
        self.scalar_indexes[sub_key] = idx
        return idx

    def index_insert(self, sub_key: str, blob_id: int) -> None:
        """DynamicIndexing for newly added items."""
        index = self.indexes.get(sub_key)
        if index is None:
            return
        serial = self.registry.serial(sub_key)
        vec = self.cache.get(blob_id, sub_key, serial)
        if vec is None:
            vec = self.aipm.extract_sync(
                sub_key, [(blob_id, self.graph.blobs.as_array(blob_id))])[blob_id]
            self.cache.put(blob_id, sub_key, serial, vec)
        index.insert(np.asarray(vec, np.float32), blob_id)

    # -- query path (paper Fig 2) -------------------------------------------------

    def plan(self, text: str, optimized: bool = True) -> lp.PlanOp:
        q = parse_query(text)
        if not isinstance(q, MatchQuery):
            raise TypeError("plan() expects a MATCH query")
        self.stats.refresh_from_graph(self.graph)
        return plan_query(self, q, optimized)

    def query(self, text: str, parameters: Optional[Dict[str, Any]] = None,
              optimized: bool = True, **params: Any) -> List[Dict[str, Any]]:
        """Compatibility wrapper over the session API: one statement, all
        rows materialized.  Prefer ``db.session()`` + ``run()``/``prepare()``
        for anything latency- or memory-sensitive."""
        if isinstance(parameters, bool):
            # legacy positional call: query(text, optimized)
            parameters, optimized = None, parameters
        if self._default_session is None:
            self._default_session = self.session()
        return self._default_session.run(text, parameters,
                                         optimized=optimized,
                                         **params).fetchall()

    def explain(self, text: str) -> Dict[str, Any]:
        self.stats.refresh_from_graph(self.graph)
        opt = self.plan(text, optimized=True)
        naive = self.plan(text, optimized=False)
        return {
            "optimized": opt.describe(),
            "optimized_cost": estimate_plan_cost(opt, self.stats),
            "naive": naive.describe(),
            "naive_cost": estimate_plan_cost(naive, self.stats),
            "plan_cache": self.plan_cache.stats(),
            "cascade": self._explain_cascade(opt),
        }

    def _explain_cascade(self, plan: lp.PlanOp) -> Dict[str, Any]:
        """Per-semantic-predicate cascade routing report: which path the
        optimizer would take at the plan's accuracy target, the calibrated
        band, expected escalation + achieved-accuracy estimate, and the
        observed (EWMA) escalation fractions / proxy throughput."""
        from repro_torch.core.cost_model import _sem_key
        preds: Dict[str, Any] = {}
        for op in lp.plan_ops(plan):
            if not isinstance(op, lp.SemanticFilter):
                continue
            sub_key = _sem_key(op.predicate)
            if not sub_key:
                continue
            acc = op.accuracy
            entry: Dict[str, Any] = {
                "accuracy_target": acc if acc is not None else 1.0,
                "proxy": self.registry.has_proxy(sub_key),
                "calibrated": False,
                "path": "direct",
            }
            n_est = self.stats.estimate_rows(op.child)
            if entry["proxy"] and acc is not None and acc < 1.0:
                thr = self.calibrator.thresholds(
                    sub_key, self.registry.serial(sub_key),
                    self.registry.serial(proxy_key(sub_key)), acc)
                if thr is not None:
                    entry.update({
                        "calibrated": True,
                        "band": (thr.lo, thr.hi),
                        "expected_escalation": thr.expected_escalation,
                        "expected_accuracy": thr.expected_accuracy,
                        "cascade_cost": self.stats.cascade_cost(
                            n_est, sub_key, thr.expected_escalation),
                        "path": self.stats.choose_semantic_path(
                            sub_key, n_est, True, thr.expected_escalation),
                    })
            entry["direct_cost"] = n_est * self.stats.phi_speed(sub_key)
            preds[sub_key] = entry
        return {
            "predicates": preds,
            "observed_escalation": self.stats.cascade_stats(),
            "proxy_scan_speed": self.stats.proxy_scan_speed(),
        }

    # -- CREATE ------------------------------------------------------------------

    def _execute_create(self, q: CreateQuery, text: str,
                        params: Optional[Dict[str, Any]] = None) -> None:
        """Apply a CREATE statement and log it.  ``params`` late-binds
        ``$name`` prop values; scalar values are inlined into the logged
        statement so followers can replay it (see session.bind_text).

        Property resolution (including blob-source reads) happens *before*
        the first graph mutation, and every bound param must have a
        WAL-replayable literal form -- so a failing statement mutates
        nothing, and whatever is applied is always also logged."""
        from repro_torch.core.cypherplus import FuncCall, Literal, Param
        from repro_torch.core.session import check_wal_renderable
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

        # phase 1: resolve every *new* node's props -- any failure (missing
        # param, unreadable blob source) aborts before the graph OR blob
        # store is touched.  Blob content is read here but registered only
        # in phase 2.
        pending_blob = object()     # marker: (pending_blob, content, mime)
        resolved: List[List[Optional[Dict[str, Any]]]] = []
        seen_vars: set = set()
        for pat in q.patterns:
            plist: List[Optional[Dict[str, Any]]] = []
            for np_ in pat.nodes:
                if np_.var in seen_vars:
                    plist.append(None)          # repeated var: reuse node
                    continue
                if np_.var:
                    seen_vars.add(np_.var)
                props: Dict[str, Any] = {}
                for k, v in np_.props:
                    if isinstance(v, (Literal, Param)):
                        props[k] = resolve(v)
                    elif isinstance(v, FuncCall) and v.name == "createFromSource":
                        src = resolve(v.args[0])
                        content, mime = self.graph.blobs.resolve_source(
                            src if isinstance(src, (str, bytes)) else str(src))
                        props[k] = (pending_blob, content, mime)
                plist.append(props)
            resolved.append(plist)

        # phase 2: apply, then log
        env: Dict[str, int] = {}
        for pat, plist in zip(q.patterns, resolved):
            prev = None
            for i, np_ in enumerate(pat.nodes):
                if np_.var in env:
                    nid = env[np_.var]
                else:
                    props = plist[i] or {}
                    for k, v in list(props.items()):
                        if isinstance(v, tuple) and len(v) == 3 \
                                and v[0] is pending_blob:
                            props[k] = self.graph.blobs.create(v[1], v[2])
                    nid = self.graph.create_node(np_.label or "Node",
                                                 log=False, **props)
                    if np_.var:
                        env[np_.var] = nid
                if prev is not None:
                    rel = pat.rels[i - 1]
                    src, dst = (prev, nid) if rel.direction != "in" else (nid, prev)
                    self.graph.create_relationship(src, dst,
                                                   rel.rel_type or "REL",
                                                   log=False)
                prev = nid
        self.graph.wal.append(bind_text(text, params))
