"""Vectorized Volcano executor (paper §IV-B).

Bindings tables are dicts var -> np.int64[rows] of node ids (a columnar
match table).  Structured predicates evaluate as vectorized column ops;
semantic predicates go through cache -> AIPM batch extraction -> vectorized
similarity on device.  Every operator execution is timed and folded into the
statistics service (|σ_p| = Σcost/|T|), closing the loop with the optimizer.

Index pushdown: a SemanticFilter of shape
    scan -> filter( var.prop->sub  ~:/::  <literal vector> )
whose sub-property has a built vector index executes as an index kNN search
instead of extracting φ for every row (paper §VI-B2: "the query plan
generator pushes the semantic-information operator into the index").

Two drive modes share the same operator kernels:

* :func:`execute`       -- materializing: one full bindings table per op.
* :func:`execute_iter`  -- streaming: scans emit bounded row chunks that
  flow through filters/expands/joins (probe side) without ever building the
  full table; ``LIMIT n`` stops pulling from the pipeline as soon as ``n``
  projected rows exist (early exit).  This is what :class:`~repro_torch.core.
  session.Cursor` iterates.

``$param`` placeholders (:class:`~repro_torch.core.cypherplus.Param`) are resolved
late, from ``ExecutionContext.params``, so one optimized plan serves every
binding of the same query skeleton.

Async φ pipeline (paper §IV-B): in the streaming driver a ``SemanticFilter``
dispatches AIPM extraction for up to ``prefetch_depth`` upcoming chunks and
keeps pulling structured work from its child while those batches resolve on
the model-service workers; it joins a chunk's futures only when the semantic
predicate actually needs the values.  In-flight requests are deduplicated
across concurrent executions through :class:`~repro_torch.core.semantic_cache.
InflightTable`, and ``LIMIT`` early exit cancels every batch no worker has
picked up yet.
"""
from __future__ import annotations

import time
from collections import deque
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import logical_plan as lp
from repro_torch.core.cascade import route_scores
from repro_torch.core.deadline import Deadline, DeadlineExceeded
from repro_torch.core.cypherplus import (
    BoolOp,
    Compare,
    FuncCall,
    Literal,
    Param,
    Prop,
    SubProp,
)

Bindings = Dict[str, np.ndarray]

SIM_THRESHOLD = 0.80

#: default cursor batch: bounds peak row-count per pipeline step
DEFAULT_BATCH_ROWS = 256


class ExecutionContext:
    def __init__(self, db, params: Optional[Dict[str, Any]] = None,
                 prefetch_depth: Optional[int] = None,
                 deadline: Optional[Deadline] = None,
                 trace=None, profile=None) -> None:
        self.db = db
        self.graph = db.graph
        self.stats = db.stats
        self.cache = db.cache
        self.aipm = db.aipm
        self.registry = db.registry
        self.inflight = db.inflight
        #: chunks of φ work kept in flight ahead of the semantic filter's
        #: consumption point (0 disables overlap; None = adaptive -- the
        #: AIPMConfig default until the stats service has observed this φ
        #: family's speed, then auto-tuned per filter from φ wait vs
        #: structured-produce time, clamped to the bounded-queue capacity)
        self.prefetch_auto = prefetch_depth is None
        self.prefetch_depth = (db.cfg.aipm.prefetch_depth
                               if prefetch_depth is None else prefetch_depth)
        self.prefetch_depth_used: Optional[int] = None
        self.params: Dict[str, Any] = dict(params or {})
        self.extract_count = 0      # φ items dispatched by *this* execution
        self.dedup_borrows = 0      # φ items shared with another execution
        self.phi_coalesced = 0      # chunks whose φ rode a merged AIPM request
        self.row_limit: Optional[int] = None   # root LIMIT (set by execute_iter)
        self.index_hits = 0
        self.scan_rows = 0          # rows emitted by leaf scans (LIMIT proof)
        # proxy-first cascade counters (WITH ACCURACY a, a < 1)
        self.proxy_scored = 0       # rows scored by a proxy tier
        self.proxy_hits = 0         # rows the proxy answered (accept|reject)
        self.escalated_rows = 0     # rows escalated to the exact φ
        self.cascade_chunks = 0     # chunks routed through the cascade path
        self._pushdown_memo: Dict[int, Any] = {}   # plan id -> index matches
        self._func_memo: Dict[int, Any] = {}       # expr id -> blob tag
        #: per-query time budget shared with every other leg of the same
        #: query (shard streams, hedge races); None = no deadline, and every
        #: deadline check below compiles to a no-op
        self.deadline = deadline
        #: per-query span tree / PROFILE accumulator, threaded exactly like
        #: the deadline (one shared object across shard streams and hedge
        #: legs); None = off, and every instrumentation site below is one
        #: attribute load + identity check
        self.trace = trace
        self.profile = profile
        if profile is not None:
            profile.register_ctx(self)

    def check_deadline(self, where: str) -> None:
        if self.deadline is not None:
            self.deadline.check(where)

    def wait_timeout(self, default_s: float) -> float:
        """Blocking-wait budget: the configured timeout clamped to the
        query's remaining deadline (the global knob when none is set)."""
        if self.deadline is None:
            return default_s
        return self.deadline.clamp(default_s)


def _rows(b: Bindings) -> int:
    for v in b.values():
        return len(v)
    return 0


def resolve_param(ctx: ExecutionContext, name: str) -> Any:
    try:
        return ctx.params[name]
    except KeyError:
        raise KeyError(f"missing query parameter ${name}; "
                       f"bound: {sorted(ctx.params) or 'none'}") from None


def _resolve_limit(n: Any, ctx: ExecutionContext) -> int:
    if isinstance(n, Param):
        n = resolve_param(ctx, n.name)
    n = int(n)
    if n < 0:
        raise ValueError(f"LIMIT must be >= 0, got {n}")
    return n


# ---------------------------------------------------------------------------
# asynchronous φ extraction (AIPM futures + cross-session in-flight dedup)
# ---------------------------------------------------------------------------


class PhiBatch:
    """Handle for one in-flight φ extraction round over a set of blob ids.

    *Owned* keys were claimed in the in-flight table by this execution and
    dispatched as one AIPM request; *borrowed* keys are being extracted by a
    concurrent execution whose futures we wait on instead of re-submitting.
    ``join`` blocks until every value is in the semantic cache; ``cancel``
    withdraws the AIPM request if no worker picked it up yet (``LIMIT`` early
    exit), releasing the owned claims so nothing waits on an orphan."""

    def __init__(self, ctx: "ExecutionContext", sub_key: str, serial: int,
                 bids: List[int], owned: List[Tuple[Tuple, Future]],
                 borrowed: Dict[Tuple, Future],
                 aipm_future: Optional[Future]) -> None:
        self.ctx = ctx
        self.sub_key = sub_key
        self.serial = serial
        self.bids = bids
        self.owned = owned
        self.borrowed = borrowed
        self.aipm_future = aipm_future

    def join(self) -> None:
        tr = self.ctx.trace
        if tr is None:
            return self._join_inner()
        with tr.span("phi.join", sub_key=self.sub_key, n=len(self.bids),
                     owned=len(self.owned), borrowed=len(self.borrowed)):
            return self._join_inner()

    def _join_inner(self) -> None:
        ctx, default_t = self.ctx, self.ctx.aipm.cfg.timeout_ms / 1000
        if self.aipm_future is not None:
            try:
                out = self.aipm_future.result(
                    timeout=ctx.wait_timeout(default_t))
            except CancelledError:
                pass                        # fall through to the sync retry
            except FuturesTimeoutError:
                self._deadline_abort("phi join")
                raise
            else:
                # consume the result directly: Future.result() can return
                # before the done-callback has filled the cache (waiters are
                # notified first), and waiting on the callback would re-extract
                for key, _f in self.owned:
                    ctx.cache.put(key[0], self.sub_key, self.serial,
                                  out.get(key[0]))
        for f in self.borrowed.values():
            try:
                f.result(timeout=ctx.wait_timeout(default_t))
            except FuturesTimeoutError:     # borrow timed out: maybe expired
                self._deadline_abort("phi borrow")
                pass                        # no deadline: retry below
            except (CancelledError, Exception):  # noqa: BLE001
                pass                        # owner bailed/failed: retry below
        retry = [b for b in self.bids
                 if ctx.cache.peek(b, self.sub_key, self.serial) is None]
        if retry:
            self._deadline_abort("phi sync retry")
            items = [(b, ctx.graph.blobs.as_array(b)) for b in retry]
            ctx.extract_count += len(items)
            out = ctx.aipm.extract_sync(self.sub_key, items,
                                        timeout=ctx.wait_timeout(default_t))
            for bid, vec in out.items():
                ctx.cache.put(bid, self.sub_key, self.serial, vec)

    def cancel(self) -> None:
        if self.aipm_future is not None:
            # success -> the done-callback discards the owned claims, and
            # borrowers of those keys re-extract for themselves; failure
            # means a worker already took it -- the callback will resolve
            # the claims normally, so nothing is ever orphaned either way
            self.aipm_future.cancel()

    def abort(self) -> None:
        """Owner is bailing out (deadline expiry): withdraw the AIPM request
        if still queued and *discard every owned claim* even if a worker is
        already extracting.  Borrowers' futures are cancelled, so they fail
        over to their own extraction instead of blocking on an orphan until
        the global timeout.  A late done-callback resolving the already-
        popped keys is a no-op; the cache still gets the values."""
        if self.aipm_future is not None:
            self.aipm_future.cancel()
        for key, _f in self.owned:
            self.ctx.inflight.discard(key)

    def _deadline_abort(self, where: str) -> None:
        """When this batch's query has run out of budget, release claims and
        raise; otherwise return and let the caller keep trying."""
        d = self.ctx.deadline
        if d is not None and d.expired():
            self.abort()
            d.check(where)


def _begin_extraction(ctx: ExecutionContext, sub_key: str,
                      blob_ids: np.ndarray) -> Optional[PhiBatch]:
    """Dispatch φ for every not-yet-cached blob id; returns a joinable handle
    or None when the cache already covers everything."""
    serial = ctx.registry.serial(sub_key)
    missing: List[int] = []
    seen = set()
    for bid in blob_ids:
        bid = int(bid)
        if bid < 0 or bid in seen:
            continue
        seen.add(bid)
        if ctx.cache.peek(bid, sub_key, serial) is None:
            missing.append(bid)
    ctx.cache.note_misses(len(missing))
    if not missing:
        if ctx.trace is not None and seen:
            ctx.trace.event("phi.cache_hit", sub_key=sub_key, n=len(seen))
        return None
    owned, borrowed = ctx.inflight.claim(
        [(b, sub_key, serial) for b in missing])
    ctx.dedup_borrows += len(borrowed)
    if ctx.trace is not None:
        ctx.trace.event("phi.dispatch", sub_key=sub_key, n=len(missing),
                        cached=len(seen) - len(missing), owned=len(owned),
                        borrowed=len(borrowed))
    aipm_future = None
    if owned:
        items = [(key[0], ctx.graph.blobs.as_array(key[0]))
                 for key, _f in owned]
        ctx.extract_count += len(items)
        try:
            aipm_future = ctx.aipm.submit(
                sub_key, items,
                timeout=ctx.wait_timeout(ctx.aipm.cfg.timeout_ms / 1000))
        except Exception:
            for key, _f in owned:
                ctx.inflight.discard(key)
            ctx.check_deadline("phi submit")   # Full + expired -> typed error
            raise
        inflight, cache = ctx.inflight, ctx.cache

        def _on_done(fut: Future, owned=owned) -> None:
            if fut.cancelled():
                for key, _f in owned:
                    inflight.discard(key)
                return
            exc = fut.exception()
            if exc is not None:
                for key, _f in owned:
                    inflight.fail(key, exc)
                return
            out = fut.result()
            for key, _f in owned:
                val = out.get(key[0])
                cache.put(key[0], sub_key, serial, val)
                inflight.resolve(key, val)

        aipm_future.add_done_callback(_on_done)
    return PhiBatch(ctx, sub_key, serial, missing, owned, borrowed,
                    aipm_future)


def _collect_subprops(expr: Any) -> List[SubProp]:
    """Per-row sub-property extractions a predicate will evaluate (prefetch
    targets).  Query-side extractions (``createFromSource(...)->k``) are one
    item, memoized through the cache -- not worth prefetching per chunk."""
    out: List[SubProp] = []
    if isinstance(expr, SubProp):
        if isinstance(expr.base, Prop):
            out.append(expr)
    elif isinstance(expr, Compare):
        out += _collect_subprops(expr.left) + _collect_subprops(expr.right)
    elif isinstance(expr, BoolOp):
        for a in expr.args:
            out += _collect_subprops(a)
    elif isinstance(expr, FuncCall):
        for a in expr.args:
            out += _collect_subprops(a)
    return out


# ---------------------------------------------------------------------------
# operator kernels (shared by the materializing and streaming drivers)
# ---------------------------------------------------------------------------


def _scan_ids(plan: lp.PlanOp, ctx: ExecutionContext) -> np.ndarray:
    if isinstance(plan, lp.AllNodeScan):
        return ctx.graph.store.all_nodes()
    return ctx.graph.store.nodes_with_label(plan.label)


def _apply_filter(plan, child: Bindings, ctx: ExecutionContext,
                  extra_time: float = 0.0) -> Bindings:
    """Filter / SemanticFilter kernel (with index pushdown), timed.
    ``extra_time`` folds upstream φ wait (prefetch join) into the one
    record per chunk, so the EWMA sees the operator's full pipelined cost."""
    n_in = _rows(child)
    t0 = time.perf_counter()
    pushed = (_try_index_pushdown(plan, child, ctx)
              if isinstance(plan, lp.SemanticFilter) else None)
    if pushed is not None:
        out = pushed
    else:
        mask = np.asarray(eval_expr(plan.predicate, child, ctx), bool)
        out = {k: v[mask] for k, v in child.items()}
    _record(ctx, plan, time.perf_counter() - t0 + extra_time, n_in,
            rows_out=_rows(out))
    return out


def _apply_expand(plan: lp.Expand, child: Bindings,
                  ctx: ExecutionContext) -> Bindings:
    n_in = _rows(child)
    t0 = time.perf_counter()
    type_id = (ctx.graph.store.rel_types.id_of(plan.rel_type)
               if plan.rel_type else None)
    if plan.dst in child:   # expand-into: existence check between bound vars
        row_idx, nbrs = ctx.graph.store.rels.expand_batch(
            child[plan.src], type_id,
            "out" if plan.direction != "in" else "in")
        ok = np.zeros(n_in, bool)
        match = child[plan.dst][row_idx] == nbrs
        np.logical_or.at(ok, row_idx[match], True)
        if plan.direction == "any":
            row_idx2, nbrs2 = ctx.graph.store.rels.expand_batch(
                child[plan.src], type_id, "in")
            match2 = child[plan.dst][row_idx2] == nbrs2
            np.logical_or.at(ok, row_idx2[match2], True)
        out = {k: v[ok] for k, v in child.items()}
    else:
        direction = plan.direction if plan.direction != "any" else "out"
        row_idx, nbrs = ctx.graph.store.rels.expand_batch(
            child[plan.src], type_id, direction)
        if plan.direction == "any":
            r2, n2 = ctx.graph.store.rels.expand_batch(
                child[plan.src], type_id, "in")
            row_idx = np.concatenate([row_idx, r2])
            nbrs = np.concatenate([nbrs, n2])
        out = {k: v[row_idx] for k, v in child.items()}
        out[plan.dst] = nbrs
    _record(ctx, plan, time.perf_counter() - t0, max(n_in, 1),
            rows_out=_rows(out))
    return out


def _key_view(b: Bindings, shared: List[str]) -> np.ndarray:
    key = np.stack([b[v] for v in shared], axis=1)
    return np.ascontiguousarray(key).view(
        [("", key.dtype)] * key.shape[1]).ravel()


def _build_join_buckets(left: Bindings,
                        shared: List[str]) -> Dict[bytes, List[int]]:
    """Build-side hash table of a join; built once per execution even when
    the probe side streams chunk-by-chunk."""
    buckets: Dict[bytes, List[int]] = {}
    for i, kv in enumerate(_key_view(left, shared)):
        buckets.setdefault(kv.tobytes(), []).append(i)
    return buckets


def _join_tables(plan: lp.Join, left: Bindings, right: Bindings,
                 ctx: ExecutionContext,
                 buckets: Optional[Dict[bytes, List[int]]] = None,
                 streamed: bool = False) -> Bindings:
    t0 = time.perf_counter()
    shared = sorted(set(left) & set(right))
    # when the probe side streams chunk-by-chunk, only the probe rows are
    # this call's input -- counting the materialized build side per chunk
    # would skew the cost model's per-row speed EWMA
    n_in = (_rows(right) if streamed or buckets is not None
            else _rows(left) + _rows(right))
    if not shared:  # cross product
        nl, nr = _rows(left), _rows(right)
        li = np.repeat(np.arange(nl), nr)
        ri = np.tile(np.arange(nr), nl)
    else:
        if buckets is None:
            buckets = _build_join_buckets(left, shared)
        li_list, ri_list = [], []
        for j, kv in enumerate(_key_view(right, shared)):
            for i in buckets.get(kv.tobytes(), ()):
                li_list.append(i)
                ri_list.append(j)
        li = np.asarray(li_list, np.int64)
        ri = np.asarray(ri_list, np.int64)
    out = {k: v[li] for k, v in left.items()}
    for k, v in right.items():
        if k not in out:
            out[k] = v[ri]
    _record(ctx, plan, time.perf_counter() - t0, max(n_in, 1),
            rows_out=len(li))
    return out


def _project_rows(plan: lp.Projection, child: Bindings,
                  ctx: ExecutionContext) -> List[Dict]:
    t0 = time.perf_counter()
    cols = []
    for item in plan.items:
        vals = eval_expr(item.expr, child, ctx)
        cols.append((item.alias or _name_of(item.expr), vals))
    n = _rows(child)

    def cell(vals: Any, i: int) -> Any:
        # str/bytes have __len__ but are scalars (e.g. a $param in RETURN),
        # not per-row columns
        if hasattr(vals, "__len__") and not isinstance(vals, (str, bytes)):
            return vals[i]
        return vals

    rows = [{name: cell(vals, i) for name, vals in cols} for i in range(n)]
    _record(ctx, plan, time.perf_counter() - t0, max(n, 1), rows_out=n)
    return rows


# ---------------------------------------------------------------------------
# materializing driver
# ---------------------------------------------------------------------------


def execute(plan: lp.PlanOp, ctx: ExecutionContext) -> Tuple[Bindings, List[Dict]]:
    """Returns (bindings, projected rows if Projection at root)."""
    if isinstance(plan, (lp.AllNodeScan, lp.NodeByLabelScan)):
        t0 = time.perf_counter()
        ids = _scan_ids(plan, ctx)
        ctx.scan_rows += len(ids)
        _record(ctx, plan, time.perf_counter() - t0, len(ids),
                rows_out=len(ids))
        return {plan.var: ids}, []
    if isinstance(plan, (lp.Filter, lp.SemanticFilter)):
        child, _ = execute(plan.child, ctx)
        return _apply_filter(plan, child, ctx), []
    if isinstance(plan, lp.Expand):
        child, _ = execute(plan.child, ctx)
        return _apply_expand(plan, child, ctx), []
    if isinstance(plan, lp.Join):
        left, _ = execute(plan.left, ctx)
        right, _ = execute(plan.right, ctx)
        return _join_tables(plan, left, right, ctx), []
    if isinstance(plan, lp.Limit):
        n = _resolve_limit(plan.n, ctx)
        child, rows = execute(plan.child, ctx)
        return {k: v[:n] for k, v in child.items()}, rows[:n]
    if isinstance(plan, lp.Projection):
        child, _ = execute(plan.child, ctx)
        return child, _project_rows(plan, child, ctx)
    raise TypeError(f"unknown plan op {type(plan)}")


# ---------------------------------------------------------------------------
# streaming driver (Cursor backend)
# ---------------------------------------------------------------------------


def _concat_bindings(chunks: List[Bindings], vars_: Any) -> Bindings:
    if not chunks:
        return {v: np.empty(0, np.int64) for v in vars_}
    return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}


def _iter_bindings(plan: lp.PlanOp, ctx: ExecutionContext,
                   batch_rows: int) -> Iterator[Bindings]:
    """Yield bindings tables in bounded chunks, leaf-to-root."""
    if isinstance(plan, (lp.AllNodeScan, lp.NodeByLabelScan)):
        t0 = time.perf_counter()
        ids = _scan_ids(plan, ctx)
        _record(ctx, plan, time.perf_counter() - t0, len(ids),
                rows_out=len(ids))
        for i in range(0, len(ids), batch_rows):
            chunk = ids[i:i + batch_rows]
            ctx.scan_rows += len(chunk)
            yield {plan.var: chunk}
        return
    if isinstance(plan, lp.SemanticFilter):
        yield from _iter_semantic_filter(plan, ctx, batch_rows)
        return
    if isinstance(plan, lp.Filter):
        for chunk in _iter_bindings(plan.child, ctx, batch_rows):
            out = _apply_filter(plan, chunk, ctx)
            if _rows(out):
                yield out
        return
    if isinstance(plan, lp.Expand):
        for chunk in _iter_bindings(plan.child, ctx, batch_rows):
            out = _apply_expand(plan, chunk, ctx)
            if _rows(out):
                yield out
        return
    if isinstance(plan, lp.Join):
        # hash join: build side materialized + hashed once, probe streamed
        left = _concat_bindings(list(_iter_bindings(plan.left, ctx, batch_rows)),
                                plan.left.vars)
        shared = sorted(set(left) & set(plan.right.vars))
        if shared:
            t0 = time.perf_counter()
            buckets = _build_join_buckets(left, shared)
            _record(ctx, plan, time.perf_counter() - t0, max(_rows(left), 1))
        else:
            buckets = None
        for rchunk in _iter_bindings(plan.right, ctx, batch_rows):
            out = _join_tables(plan, left, rchunk, ctx, buckets=buckets,
                               streamed=True)
            if _rows(out):
                yield out
        return
    # anything else (mid-tree Limit/Projection): materialize, then chunk
    bindings, _ = execute(plan, ctx)
    n = _rows(bindings)
    for i in range(0, n, batch_rows):
        yield {k: v[i:i + batch_rows] for k, v in bindings.items()}


def _pushdown_covered(plan: lp.SemanticFilter,
                      ctx: ExecutionContext) -> List[SubProp]:
    """Cheap static check: which per-row extractions would index pushdown
    make moot for this filter?  Returns the covered SubProp expressions --
    prefetch skips exactly these and still dispatches φ for the rest (e.g.
    the query side of a var-var similarity whose other side is indexed).
    Conservative: a covered entry that later falls through just loses
    prefetch."""
    pred = plan.predicate
    if not isinstance(pred, Compare):
        return []
    covered: List[SubProp] = []
    for side in (pred.left, pred.right):
        if not (isinstance(side, SubProp) and isinstance(side.base, Prop)):
            continue
        if pred.op == "~:":
            index = ctx.db.indexes.get(side.sub_key)
        elif pred.op in ("=", "<", ">", "<=", ">="):
            index = ctx.db.scalar_indexes.get(side.sub_key)
        else:
            index = None
        if index is not None and \
                index.serial == ctx.registry.serial(side.sub_key):
            covered.append(side)
            break   # one indexed side carries the pushdown; the other
            #         side (if any) still needs its φ extracted
    return covered


class _CascadeSpec:
    """Everything the cascade iterator needs, resolved once per filter."""

    __slots__ = ("sub_key", "proxy_sub", "proxy_bases", "exact_bases",
                 "score_expr", "negate", "thr")

    def __init__(self, sub_key, proxy_sub, proxy_bases, exact_bases,
                 score_expr, negate, thr):
        self.sub_key = sub_key
        self.proxy_sub = proxy_sub
        self.proxy_bases = proxy_bases    # Prop-based SubProps, proxy tier
        self.exact_bases = exact_bases    # Prop-based SubProps, exact tier
        self.score_expr = score_expr      # Compare("::", proxy_l, proxy_r)
        self.negate = negate              # predicate op is "!:"
        self.thr = thr                    # CascadeThresholds for the target


def _cascade_spec(plan: lp.SemanticFilter,
                  ctx: ExecutionContext) -> Optional[_CascadeSpec]:
    """Decide (once per filter, per execution) whether this SemanticFilter
    runs as a proxy cascade.  Eligibility: a sub-unity accuracy target, a
    boolean similarity predicate over one φ family, a registered proxy, a
    calibration curve for the *current* serial pair, no index pushdown
    (pushdown answers without any φ, beating both paths), and a cost-model
    vote -- ``choose_semantic_path`` prices proxy + escalation·φ against
    direct φ with the calibrator's expected escalation for this target."""
    from repro_torch.core.aipm import proxy_key

    acc = getattr(plan, "accuracy", None)
    if acc is None or acc >= 1.0:
        return None
    pred = plan.predicate
    if not isinstance(pred, Compare) or pred.op not in ("~:", "!:"):
        return None
    left, right = pred.left, pred.right
    if not (isinstance(left, SubProp) and isinstance(right, SubProp)):
        return None
    if left.sub_key != right.sub_key:
        return None
    sub_key = left.sub_key
    if not getattr(ctx.registry, "has_proxy", lambda _k: False)(sub_key):
        return None
    calibrator = getattr(ctx.db, "calibrator", None)
    if calibrator is None:
        return None
    if _pushdown_covered(plan, ctx):
        return None
    pk = proxy_key(sub_key)
    thr = calibrator.thresholds(sub_key, ctx.registry.serial(sub_key),
                                ctx.registry.serial(pk), acc)
    if thr is None:
        return None
    n_est = ctx.stats.estimate_rows(plan.child)
    if ctx.deadline is not None:
        # degradation ladder: when the estimated cascade cost does not fit
        # the remaining budget, relax the accuracy target one notch -- a
        # wider confident region escalates fewer rows to the exact φ
        rem = ctx.deadline.remaining()
        est = ctx.stats.cascade_cost(n_est, sub_key, thr.expected_escalation)
        if 0 < rem < est:
            cost_cfg = ctx.db.cfg.cost
            relaxed = max(cost_cfg.accuracy_relax_floor,
                          acc - cost_cfg.accuracy_relax_notch)
            if relaxed < acc:
                thr2 = calibrator.thresholds(
                    sub_key, ctx.registry.serial(sub_key),
                    ctx.registry.serial(pk), relaxed)
                if thr2 is not None:
                    thr = thr2
                    ctx.deadline.note_degradation("relax_accuracy")
    if ctx.stats.choose_semantic_path(
            sub_key, n_est, True, thr.expected_escalation) != "cascade":
        return None
    proxy_l = SubProp(left.base, pk)
    proxy_r = SubProp(right.base, pk)
    proxy_bases = [sp for sp in dict.fromkeys((proxy_l, proxy_r))
                   if isinstance(sp.base, Prop)]
    exact_bases = [sp for sp in dict.fromkeys((left, right))
                   if isinstance(sp.base, Prop)]
    return _CascadeSpec(sub_key, pk, proxy_bases, exact_bases,
                        Compare("::", proxy_l, proxy_r),
                        pred.op == "!:", thr)


def _iter_cascade_filter(plan: lp.SemanticFilter, ctx: ExecutionContext,
                         batch_rows: int, spec: _CascadeSpec
                         ) -> Iterator[Bindings]:
    """Two-stage streaming SemanticFilter (WITH ACCURACY a, a < 1).

    Stage 1 rides the existing prefetch machinery: *proxy* φ for up to
    ``depth`` upcoming chunks is dispatched to the AIPM pool while earlier
    chunks are being scored.  Routing against the calibrated [lo, hi] band
    answers most rows outright; the uncertain remainder flows into a bounded
    *escalation* window whose exact-φ batches are dispatched ahead of their
    consumption point too -- so proxy scoring of chunk k+1 overlaps exact
    extraction of chunk k.  Both tiers share the in-flight dedup table and
    the semantic cache (tiered by the ``#proxy`` key suffix), chunks are
    yielded strictly in child order, and closing the generator (``LIMIT``
    early exit, cursor close) cancels every batch -- proxy or exact -- no
    worker has picked up yet."""
    depth = max(1, ctx.prefetch_depth)
    ctx.prefetch_depth_used = depth
    lo, hi = spec.thr.lo, spec.thr.hi
    child_it = _iter_bindings(plan.child, ctx, batch_rows)
    # (chunk, proxy handles) awaiting scoring
    scoring: "deque[Tuple[Bindings, List[PhiBatch]]]" = deque()
    # (chunk, answer mask, escalate mask, sub-chunk, exact handles, t_proxy)
    escalating: "deque[Tuple[Bindings, np.ndarray, np.ndarray, Optional[Bindings], List[PhiBatch], float]]" = deque()
    exhausted = False
    try:
        while True:
            while not exhausted and len(scoring) < depth:
                chunk = next(child_it, None)
                if chunk is None:
                    exhausted = True
                    break
                handles = []
                for sp in spec.proxy_bases:
                    h = _begin_extraction(ctx, spec.proxy_sub,
                                          _blob_ids_for(sp.base, chunk, ctx))
                    if h is not None:
                        handles.append(h)
                scoring.append((chunk, handles))
            while scoring and len(escalating) < depth:
                chunk, handles = scoring.popleft()
                t0 = time.perf_counter()
                for h in handles:
                    h.join()
                scores = np.asarray(
                    eval_expr(spec.score_expr, chunk, ctx), np.float64)
                accept, reject, esc = route_scores(scores, lo, hi)
                if spec.negate:
                    accept, reject = reject, accept
                t_proxy = time.perf_counter() - t0
                n = scores.size
                ctx.stats.record_proxy_scan(t_proxy, n)
                ctx.stats.record_escalation(spec.sub_key, int(esc.sum()), n)
                ctx.proxy_scored += n
                ctx.proxy_hits += n - int(esc.sum())
                ctx.escalated_rows += int(esc.sum())
                if ctx.trace is not None:
                    ctx.trace.add_timed(
                        "cascade.proxy_score", t_proxy, n=n,
                        accepted=int(accept.sum()), rejected=int(reject.sum()),
                        escalated=int(esc.sum()))
                sub = None
                ehandles: List[PhiBatch] = []
                if esc.any():
                    if ctx.trace is not None:
                        ctx.trace.event("cascade.escalate", n=int(esc.sum()),
                                        sub_key=spec.sub_key)
                    sub = {k: v[esc] for k, v in chunk.items()}
                    for sp in spec.exact_bases:
                        h = _begin_extraction(
                            ctx, spec.sub_key,
                            _blob_ids_for(sp.base, sub, ctx))
                        if h is not None:
                            ehandles.append(h)
                escalating.append((chunk, accept, esc, sub, ehandles,
                                   t_proxy))
            if not escalating:
                return
            chunk, accept, esc, sub, ehandles, t_proxy = escalating.popleft()
            t0 = time.perf_counter()
            for h in ehandles:
                h.join()
            mask = accept.copy()
            if sub is not None:
                exact = np.asarray(
                    eval_expr(plan.predicate, sub, ctx), bool)
                mask[esc] = exact
            ctx.cascade_chunks += 1
            _record(ctx, plan, time.perf_counter() - t0 + t_proxy,
                    max(len(mask), 1), rows_out=int(mask.sum()))
            out = {k: v[mask] for k, v in chunk.items()}
            if _rows(out):
                yield out
    finally:
        for _chunk, handles in scoring:
            for h in handles:
                h.cancel()
        for _chunk, _a, _e, _sub, ehandles, _t in escalating:
            for h in ehandles:
                h.cancel()
        child_it.close()


def _iter_semantic_filter(plan: lp.SemanticFilter, ctx: ExecutionContext,
                          batch_rows: int) -> Iterator[Bindings]:
    """SemanticFilter stage of the streaming driver: φ for up to
    ``ctx.prefetch_depth`` upcoming chunks is dispatched to the AIPM service
    while earlier chunks are being similarity-tested and while the child
    pipeline (scans, cheap structured filters) produces the next chunks --
    extraction latency overlaps structured query work instead of serializing
    into every cursor pull.  Chunks are joined and yielded strictly in child
    order, so results are byte-identical to the synchronous path.  Closing
    the generator (``LIMIT`` early exit, cursor close) cancels every φ batch
    not yet picked up by a worker."""
    spec = _cascade_spec(plan, ctx)
    if spec is not None:
        yield from _iter_cascade_filter(plan, ctx, batch_rows, spec)
        return
    depth = ctx.prefetch_depth
    if ctx.prefetch_auto and depth > 0:
        # adaptive window: observed φ wait vs structured-produce time,
        # clamped to the AIPM bounded-queue capacity (deeper would only
        # block on backpressure).  Explicit session overrides, a config
        # prefetch_depth of 0 (sync mode stays sync), and cold starts
        # (no observed speed yet) keep ctx.prefetch_depth
        adaptive = ctx.stats.suggest_prefetch_depth(
            plan, ctx.aipm.cfg.max_inflight)
        if adaptive is not None:
            depth = adaptive
    ctx.prefetch_depth_used = depth
    # dedupe: `x ~: x` style predicates name the same extraction twice;
    # skip extractions an index pushdown will cover (the rest -- e.g. the
    # query side of a var-var similarity -- still prefetch normally)
    subprops = list(dict.fromkeys(_collect_subprops(plan.predicate)))
    covered = _pushdown_covered(plan, ctx)
    subprops = [sp for sp in subprops if sp not in covered]
    if depth <= 0 or not subprops:
        for chunk in _iter_bindings(plan.child, ctx, batch_rows):
            out = _apply_filter(plan, chunk, ctx)
            if _rows(out):
                yield out
        return
    child_it = _iter_bindings(plan.child, ctx, batch_rows)
    pending: "deque[Tuple[Bindings, List[PhiBatch]]]" = deque()
    exhausted = False

    def dispatch(chunks: List[Bindings]) -> None:
        """φ for a window refill.  When the AIPM queue is idle and several
        chunks arrived together, their blob ids merge into ONE request per
        sub-property (cross-chunk coalescing: fewer, larger model-service
        calls); the shared handle is joinable/cancellable from every chunk.
        Otherwise each chunk dispatches its own batch as before.  A root
        ``LIMIT`` disables coalescing: a merged request is picked up whole
        by the first free worker, which would defeat early-exit
        cancellation exactly where it matters."""
        if len(chunks) > 1 and ctx.row_limit is None \
                and ctx.aipm.pending() == 0:
            handles = []
            for sp in subprops:
                bids = np.concatenate(
                    [_blob_ids_for(sp.base, c, ctx) for c in chunks])
                h = _begin_extraction(ctx, sp.sub_key, bids)
                if h is not None:
                    handles.append(h)
            ctx.phi_coalesced += len(chunks)
            for chunk in chunks:
                pending.append((chunk, list(handles)))
            return
        for chunk in chunks:
            handles = []
            for sp in subprops:
                h = _begin_extraction(ctx, sp.sub_key,
                                      _blob_ids_for(sp.base, chunk, ctx))
                if h is not None:
                    handles.append(h)
            pending.append((chunk, handles))

    try:
        while True:
            fresh: List[Bindings] = []
            while not exhausted and len(pending) + len(fresh) < depth:
                chunk = next(child_it, None)
                if chunk is None:
                    exhausted = True
                    break
                fresh.append(chunk)
            if fresh:
                dispatch(fresh)
            if not pending:
                return
            chunk, handles = pending.popleft()
            t0 = time.perf_counter()
            for h in handles:
                h.join()
            out = _apply_filter(plan, chunk, ctx,
                                extra_time=time.perf_counter() - t0)
            if _rows(out):
                yield out
    finally:
        for _chunk, handles in pending:
            for h in handles:
                h.cancel()
        child_it.close()


def execute_iter(plan: lp.PlanOp, ctx: ExecutionContext,
                 batch_rows: int = DEFAULT_BATCH_ROWS) -> Iterator[List[Dict]]:
    """Stream projected rows in bounded batches (each a list of dicts).

    ``Limit`` at the root exits early: once ``n`` rows have been yielded the
    upstream generators are closed and no further scan chunk is pulled, so a
    ``LIMIT 5`` over a million-node scan touches ~``batch_rows`` rows.
    """
    it = _execute_iter_core(plan, ctx, None, batch_rows, None)
    try:
        for _ids, rows in it:
            yield rows
    finally:
        it.close()


def execute_iter_tagged(plan: lp.PlanOp, ctx: ExecutionContext,
                        anchor: str, batch_rows: int = DEFAULT_BATCH_ROWS,
                        limit: Optional[int] = None
                        ) -> Iterator[Tuple[np.ndarray, List[Dict]]]:
    """Stream ``(anchor_ids, projected_rows)`` batches: :func:`execute_iter`
    with each batch tagged by the ``anchor`` variable's node ids.

    This is the cluster scatter leg: the coordinator's ordered merge needs
    every row's anchor id to interleave shard streams back into the global
    (single-node) row order, and the per-shard ``limit`` cap preserves
    ``LIMIT`` early exit -- each shard contributes at most ``limit`` rows to
    an ordered merge, so nothing past the cap is ever scanned or extracted.
    Closing the generator tears the pipeline down exactly like
    :func:`execute_iter` (φ cancellation included)."""
    return _execute_iter_core(plan, ctx, anchor, batch_rows, limit)


def _execute_iter_core(plan: lp.PlanOp, ctx: ExecutionContext,
                       anchor: Optional[str], batch_rows: int,
                       limit: Optional[int]
                       ) -> Iterator[Tuple[Optional[np.ndarray], List[Dict]]]:
    """One streaming driver for both entry points: yields
    ``(anchor_ids | None, rows)`` batches with root-``Limit`` early exit and
    deterministic pipeline teardown (closing cancels any φ batches still in
    the prefetch window)."""
    if isinstance(plan, lp.Limit):
        n = _resolve_limit(plan.n, ctx)
        limit = n if limit is None else min(limit, n)
        plan = plan.child
    ctx.row_limit = limit
    proj: Optional[lp.Projection] = None
    if isinstance(plan, lp.Projection):
        proj, plan = plan, plan.child
    if anchor is not None and anchor not in plan.vars:
        raise KeyError(f"anchor var {anchor!r} not bound by plan "
                       f"(vars: {sorted(plan.vars)})")
    if limit == 0:
        return
    produced = 0
    it = _iter_bindings(plan, ctx, batch_rows)
    try:
        for chunk in it:
            # chunk-boundary deadline check: the budget contract is "never
            # exceed the deadline by more than one chunk interval", and this
            # is the one place every streaming plan passes once per chunk
            ctx.check_deadline("chunk boundary")
            ids = (np.asarray(chunk[anchor], np.int64)
                   if anchor is not None else None)
            if proj is not None:
                rows = _project_rows(proj, chunk, ctx)
            else:
                n = _rows(chunk)
                rows = [{k: int(v[i]) for k, v in chunk.items()}
                        for i in range(n)]
            if not rows:
                continue
            if limit is not None and produced + len(rows) >= limit:
                take = limit - produced
                yield (ids[:take] if ids is not None else None), rows[:take]
                return
            produced += len(rows)
            yield ids, rows
    finally:
        it.close()


def _record(ctx: ExecutionContext, op: lp.PlanOp, dt: float, rows: int,
            rows_out: Optional[int] = None) -> None:
    """Per-operator chokepoint: cost-model EWMA feed, plus (when this query
    is traced/profiled) one completed span and one PROFILE sample."""
    key = ctx.stats.op_key(op)
    ctx.stats.record(key, dt, rows)
    if ctx.profile is not None:
        ctx.profile.note(op, key, dt, rows, rows_out)
    if ctx.trace is not None:
        ctx.trace.add_timed(key, dt, rows_in=rows, rows_out=rows_out)


def _name_of(expr: Any) -> str:
    if isinstance(expr, Prop):
        return f"{expr.var}.{expr.key}"
    if isinstance(expr, SubProp):
        return f"{_name_of(expr.base)}->{expr.sub_key}"
    return "expr"


# ---------------------------------------------------------------------------
# expression evaluation
# ---------------------------------------------------------------------------


def eval_expr(expr: Any, b: Bindings, ctx: ExecutionContext):
    n = _rows(b)
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, Param):
        return resolve_param(ctx, expr.name)
    if isinstance(expr, Prop):
        if expr.key == "__self__":
            return b[expr.var]
        col = ctx.graph.store.node_props.column(expr.key)
        ids = b[expr.var]
        if col is None:
            return np.array([None] * n, object)
        if col.kind == "string":
            return np.array(
                [col.values[i] if i < len(col.present) and col.present[i]
                 else None for i in ids], object)
        vals = np.asarray(col.values)
        safe = np.clip(ids, 0, len(vals) - 1) if len(vals) else ids
        out = vals[safe].astype(object)
        present = np.asarray(col.present)
        ok = (ids < len(present)) & present[np.clip(ids, 0, len(present) - 1)]
        out[~ok] = None
        return out
    if isinstance(expr, SubProp):
        return eval_subprop(expr, b, ctx)
    if isinstance(expr, FuncCall):
        if expr.name == "createFromSource":
            # memoized per execution: the streaming driver evaluates the
            # predicate once per chunk, and the source/params are fixed for
            # the whole statement -- one blob per request, not per chunk
            tag = ctx._func_memo.get(id(expr))
            if tag is None:
                src = eval_expr(expr.args[0], b, ctx)
                blob = ctx.graph.blobs.create_from_source(
                    src if isinstance(src, (str, bytes)) else str(src))
                tag = ("__blob__", blob.blob_id)
                ctx._func_memo[id(expr)] = tag
            return tag
        raise KeyError(f"unknown function {expr.name!r}")
    if isinstance(expr, BoolOp):
        if expr.op == "AND":
            out = np.ones(n, bool)
            for a in expr.args:
                out &= np.asarray(eval_expr(a, b, ctx), bool)
            return out
        if expr.op == "OR":
            out = np.zeros(n, bool)
            for a in expr.args:
                out |= np.asarray(eval_expr(a, b, ctx), bool)
            return out
        return ~np.asarray(eval_expr(expr.args[0], b, ctx), bool)
    if isinstance(expr, Compare):
        return eval_compare(expr, b, ctx)
    raise TypeError(f"cannot evaluate {expr!r}")


def _blob_ids_for(expr: Any, b: Bindings, ctx: ExecutionContext) -> np.ndarray:
    """Resolve the BLOB ids an extractor should run on."""
    if isinstance(expr, Prop):
        col = ctx.graph.store.node_props.column(expr.key)
        ids = b[expr.var]
        if col is None or col.kind != "blob":
            raise TypeError(f"{expr.var}.{expr.key} is not a BLOB property")
        vals = np.asarray(col.values, np.int64)
        return vals[ids]
    if isinstance(expr, FuncCall):
        tag = eval_expr(expr, b, ctx)
        return np.full(_rows(b) or 1, tag[1], np.int64)
    raise TypeError(f"cannot extract sub-property of {expr!r}")


def eval_subprop(expr: SubProp, b: Bindings, ctx: ExecutionContext):
    """φ(item, key, sub_key) with cache -> in-flight dedup -> AIPM batch
    extraction.  When the streaming driver prefetched this chunk the values
    are already cached (or in flight) and this degenerates to a gather."""
    blob_ids = _blob_ids_for(expr.base, b, ctx)
    sub_key = expr.sub_key
    serial = ctx.registry.serial(sub_key)
    batch = _begin_extraction(ctx, sub_key, blob_ids)
    if batch is not None:
        batch.join()
    out = [ctx.cache.get(int(bid), sub_key, serial) if bid >= 0 else None
           for bid in blob_ids]
    if out and isinstance(out[0], np.ndarray):
        return np.stack([o if o is not None else np.zeros_like(out[0])
                         for o in out])
    return np.array(out, object)


def _similarity(x, y) -> np.ndarray:
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if x.ndim == 1:
        x = x[None]
    if y.ndim == 1:
        y = y[None]
    if y.shape[0] == 1 and x.shape[0] > 1:
        y = np.broadcast_to(y, x.shape)
    if x.shape[0] == 1 and y.shape[0] > 1:
        x = np.broadcast_to(x, y.shape)
    num = np.sum(x * y, axis=-1)
    den = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
    return num / np.maximum(den, 1e-9)


def eval_compare(expr: Compare, b: Bindings, ctx: ExecutionContext):
    op = expr.op
    if op in ("::", "~:", "!:"):
        lx = _vector_side(expr.left, b, ctx)
        rx = _vector_side(expr.right, b, ctx)
        sim = _similarity(lx, rx)
        if op == "::":
            return sim
        if op == "~:":
            return sim >= SIM_THRESHOLD
        return sim < SIM_THRESHOLD
    if op in ("<:", ">:"):
        lv = eval_expr(expr.left, b, ctx)
        rv = eval_expr(expr.right, b, ctx)
        if op == ">:":
            lv, rv = rv, lv
        return _contained_in(lv, rv, _rows(b))
    lv = eval_expr(expr.left, b, ctx)
    rv = eval_expr(expr.right, b, ctx)
    n = _rows(b)
    lv = _broadcast(lv, n)
    rv = _broadcast(rv, n)
    if op == "=":
        return _eq(lv, rv)
    if op == "<>":
        return ~_eq(lv, rv)
    lf = lv.astype(np.float64)
    rf = rv.astype(np.float64)
    if op == "<":
        return lf < rf
    if op == "<=":
        return lf <= rf
    if op == ">":
        return lf > rf
    if op == ">=":
        return lf >= rf
    if op == "CONTAINS":
        return np.array([str(r) in str(l) for l, r in zip(lv, rv)])
    raise KeyError(f"unknown comparison {op!r}")


def _vector_side(expr: Any, b: Bindings, ctx: ExecutionContext):
    if isinstance(expr, SubProp):
        return eval_subprop(expr, b, ctx)
    val = eval_expr(expr, b, ctx)
    if isinstance(val, tuple) and val[0] == "__blob__":
        raise TypeError("similarity against raw blob: wrap with ->subProperty")
    return val


def _contained_in(lv, rv, n: int) -> np.ndarray:
    lv = _broadcast(np.asarray(lv, object), n)
    rv = _broadcast(np.asarray(rv, object), n)
    out = np.zeros(n, bool)
    for i in range(n):
        l, r = lv[i], rv[i]
        if l is None or r is None:
            continue
        if isinstance(r, (list, tuple, set, np.ndarray)) and not isinstance(r, str):
            out[i] = l in r
        else:
            out[i] = str(l) in str(r)
    return out


def _broadcast(v, n: int) -> np.ndarray:
    if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
        return v
    if isinstance(v, np.ndarray) and v.ndim > 1:
        return v
    return np.array([v] * n, object)


def _eq(lv: np.ndarray, rv: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lv), bool)
    for i, (l, r) in enumerate(zip(lv, rv)):
        if isinstance(l, float) and isinstance(r, (int, float)):
            out[i] = abs(l - float(r)) < 1e-9
        else:
            out[i] = l == r
    return out


# ---------------------------------------------------------------------------
# vector-index pushdown
# ---------------------------------------------------------------------------


def _try_index_pushdown(plan: lp.SemanticFilter, child: Bindings,
                        ctx: ExecutionContext) -> Optional[Bindings]:
    pred = plan.predicate
    if not isinstance(pred, Compare):
        return None
    if pred.op in ("=", "<", ">", "<=", ">="):
        return _try_scalar_pushdown(plan, pred, child, ctx)
    if pred.op not in ("~:", "::"):
        return None
    # normalize: var-side on the left, literal/query side on the right
    def side_info(e):
        if isinstance(e, SubProp) and isinstance(e.base, Prop):
            return ("var", e)
        if isinstance(e, SubProp) and isinstance(e.base, FuncCall):
            return ("query", e)
        return (None, e)

    lk, le = side_info(pred.left)
    rk, re_ = side_info(pred.right)
    if pred.op == "::":
        return None  # raw similarity values requested; cannot prefilter
    if lk == "var" and rk == "query":
        var_expr, query_expr = le, re_
    elif rk == "var" and lk == "query":
        var_expr, query_expr = re_, le
    elif lk == "var" and rk == "var":
        return _try_var_var_pushdown(plan, le, re_, child, ctx)
    else:
        return None
    index = ctx.db.indexes.get(var_expr.sub_key)
    if index is None or index.serial != ctx.registry.serial(var_expr.sub_key):
        return None
    # extract the query vector (1 item), search the index; memoized per plan
    # node so the streaming driver searches once, not once per chunk
    if id(plan) in ctx._pushdown_memo:
        sim_ok = ctx._pushdown_memo[id(plan)]
    else:
        qvec = eval_subprop(query_expr, {v: a[:1] for v, a in child.items()}, ctx)
        qvec = np.asarray(qvec, np.float32).reshape(1, -1)
        sim_ok = _index_matches(index, qvec, ctx)[0]
        ctx._pushdown_memo[id(plan)] = sim_ok
        ctx.index_hits += 1
    # index returns *blob ids*; map rows whose blob id matched
    col = ctx.graph.store.node_props.column(var_expr.base.key)
    blob_vals = np.asarray(col.values, np.int64)[child[var_expr.base.var]]
    keep = np.isin(blob_vals, sim_ok)
    return {kk: vv[keep] for kk, vv in child.items()}


def _index_matches(index, qvecs: np.ndarray,
                   ctx: ExecutionContext) -> List[np.ndarray]:
    """Above-threshold blob ids for every query row, via ONE batched
    ``search_many`` per round.  k is sized from the whole graph, not the
    current chunk; if any query's matches saturate k the whole batch
    re-searches with doubled k until every tail falls below the threshold or
    the index is exhausted.  Probe width (exact scan vs IVF probe) comes
    from the cost model, and observed scan throughput flows back into it."""
    thr = _index_threshold(index)
    n_index = index.n_total
    nprobe = ctx.stats.choose_knn_nprobe(index, q=qvecs.shape[0])
    k = min(max(64, ctx.graph.n_nodes // 10 + 1), n_index)
    rerank = True
    if ctx.deadline is not None:
        # degradation ladder: with a tight budget the cost model may skip
        # the exact PQ re-rank (scores become ADC approximations) and/or
        # cap the probe width; each step lands in the query's degradations
        nprobe, rerank, steps = ctx.stats.negotiate_knn_budget(
            index, qvecs.shape[0], nprobe, k, ctx.deadline.remaining())
        for step in steps:
            ctx.deadline.note_degradation(
                step, approximate=(step == "skip_rerank"))
            if ctx.trace is not None:
                ctx.trace.event("degradation", step=step)
    t0 = time.perf_counter()
    while True:
        vals, ids = index.search_many(qvecs, k, nprobe=nprobe, rerank=rerank,
                                      stats=ctx.stats)
        ok = vals >= thr
        if int(ok.sum(axis=1).max(initial=0)) < k or k >= n_index:
            break
        k = min(2 * k, n_index)
    if ctx.trace is not None:
        ctx.trace.add_timed("index.knn", time.perf_counter() - t0,
                            q=qvecs.shape[0], k=k, nprobe=nprobe,
                            rerank=rerank)
    return [ids[i][ok[i]] for i in range(qvecs.shape[0])]


def _try_var_var_pushdown(plan: lp.SemanticFilter, le: SubProp, re_: SubProp,
                          child: Bindings,
                          ctx: ExecutionContext) -> Optional[Bindings]:
    """Similarity between two bound variables' sub-properties, one of which
    is indexed: extract φ only for the *query* side (deduped by blob id),
    run ONE batched ``search_many`` over the chunk's distinct query vectors,
    and keep rows whose indexed-side blob lands in its query's
    above-threshold neighbor set.  Replaces per-row extraction of the
    indexed side with index scans (paper §VI-B2 pushdown, batched)."""
    n = _rows(child)
    idx_expr = query_expr = None
    for a, b in ((le, re_), (re_, le)):
        cand = ctx.db.indexes.get(a.sub_key)
        if cand is not None and cand.serial == ctx.registry.serial(a.sub_key):
            index, idx_expr, query_expr = cand, a, b
            break
    if idx_expr is None:
        return None
    try:
        corp_bids = _blob_ids_for(idx_expr.base, child, ctx)
        q_bids = _blob_ids_for(query_expr.base, child, ctx)
    except TypeError:
        return None
    ctx.index_hits += 1
    # self-similarity (`x ~: x`): sim(φ, φ) = 1 -- rows with a blob pass
    if idx_expr == query_expr:
        keep = corp_bids >= 0
        return {k: v[keep] for k, v in child.items()}
    keep = np.zeros(n, bool)
    valid = (q_bids >= 0) & (corp_bids >= 0)
    uniq, rep, inv = np.unique(q_bids, return_index=True, return_inverse=True)
    live = uniq >= 0
    if live.any():
        rep_rows = {k: v[rep[live]] for k, v in child.items()}
        qvecs = np.asarray(eval_subprop(query_expr, rep_rows, ctx),
                           np.float32).reshape(int(live.sum()), -1)
        matches = _index_matches(index, qvecs, ctx)
        for u, match in zip(np.nonzero(live)[0], matches):
            sel = (inv == u) & valid
            if sel.any():
                keep[sel] = np.isin(corp_bids[sel], match)
    return {k: v[keep] for k, v in child.items()}


def _try_scalar_pushdown(plan: lp.SemanticFilter, pred: Compare,
                         child: Bindings,
                         ctx: ExecutionContext) -> Optional[Bindings]:
    """Numeric (B-tree) / inverted-index pushdown (paper §VI-B2): the query
    plan generator pushes the semantic-information operator into the index
    instead of extracting φ per row.  The matching blob-id set is memoized
    per plan node so the streaming driver looks up once, not per chunk."""
    from repro_torch.core.scalar_index import InvertedIndex, NumericIndex

    # normalize: SubProp(var.prop)->sk  <op>  Literal-or-Param
    left, right, op = pred.left, pred.right, pred.op
    if isinstance(right, SubProp) and isinstance(left, (Literal, Param)):
        left, right = right, left
        op = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(op, op)
    if not (isinstance(left, SubProp) and isinstance(left.base, Prop)
            and isinstance(right, (Literal, Param))):
        return None
    if id(plan) in ctx._pushdown_memo:
        ok_ids = ctx._pushdown_memo[id(plan)]
    else:
        index = ctx.db.scalar_indexes.get(left.sub_key)
        if index is None or index.serial != ctx.registry.serial(left.sub_key):
            return None
        val = (right.value if isinstance(right, Literal)
               else resolve_param(ctx, right.name))
        if isinstance(index, NumericIndex):
            if not isinstance(val, (int, float)):
                return None
            if op == "=":
                ok_ids = index.eq(float(val))
            elif op in ("<", "<="):
                ok_ids = index.range(hi=float(val), inclusive=(op == "<="))
            else:
                ok_ids = index.range(lo=float(val), inclusive=(op == ">="))
        elif isinstance(index, InvertedIndex):
            if op != "=":
                return None
            ok_ids = index.lookup(str(val))
        else:
            return None
        ctx._pushdown_memo[id(plan)] = ok_ids
        ctx.index_hits += 1
    col = ctx.graph.store.node_props.column(left.base.key)
    if col is None or col.kind != "blob":
        return None
    blob_vals = np.asarray(col.values, np.int64)[child[left.base.var]]
    keep = np.isin(blob_vals, ok_ids)
    return {k: v[keep] for k, v in child.items()}


def _index_threshold(index) -> float:
    if index.cfg.metric in ("cosine", "ip"):
        return SIM_THRESHOLD
    # l2 scores are negative squared distances; cosine-normalized vectors:
    # |x-y|^2 = 2 - 2 cos  =>  cos >= t  <=>  -|x-y|^2 >= 2t - 2
    return 2.0 * SIM_THRESHOLD - 2.0
