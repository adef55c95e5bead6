"""Scatter-gather execution legs for the cluster coordinator.

A statement fans out only when every shard can evaluate it over its own
slice with no remote reads -- :func:`fanout_anchor` proves that statically
from the physical plan (the *anchor* is the leaf scan's variable; rows are
owned by the anchor's shard):

* expands must leave the anchor ``out``-ward (edges are co-located with
  their source node, so an owned anchor's out-edges are always local);
* predicates / projections may touch the anchor's properties and
  sub-properties, and any other variable only as a bare id (``__self__``);
* joins and multi-hop chains need distributed joins -- the ROADMAP
  follow-on -- and raise :class:`ClusterUnsupportedQuery` instead of
  silently returning partial rows.

Per-shard streams come from
:func:`repro_torch.core.executor.execute_iter_tagged` (projected rows
tagged with anchor ids, per-shard ``LIMIT`` cap), and
:func:`ordered_merge` interleaves them back into the exact single-node row
order: every stream is non-decreasing in anchor id (scans emit ascending
ids; filters/expands preserve order) and ownership is disjoint, so a k-way
merge on the anchor id is a total order.  ``LIMIT`` early exit closes every
shard pipeline (φ cancellation included) as soon as the merged row count
hits the cap.
"""
from __future__ import annotations

import heapq
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import logical_plan as lp
from repro_torch.core.cypherplus import (
    BoolOp,
    Compare,
    FuncCall,
    Literal,
    MatchQuery,
    Param,
    Prop,
    SubProp,
)


class ClusterUnsupportedQuery(NotImplementedError):
    """The statement needs data that is not shard-local (distributed joins,
    in-expands, remote property reads): see README "Sharded serving"."""


def fanout_anchor(plan: lp.PlanOp) -> str:
    """Validate shard-local evaluability of ``plan``; return the anchor var.

    Raises :class:`ClusterUnsupportedQuery` with the offending construct
    otherwise."""
    node = plan
    if isinstance(node, lp.Limit):
        node = node.child
    proj: Optional[lp.Projection] = None
    if isinstance(node, lp.Projection):
        proj, node = node, node.child
    chain: List[lp.PlanOp] = []
    while True:
        if isinstance(node, (lp.AllNodeScan, lp.NodeByLabelScan)):
            anchor = node.var
            break
        if isinstance(node, (lp.Filter, lp.SemanticFilter, lp.Expand)):
            chain.append(node)
            node = node.child
            continue
        raise ClusterUnsupportedQuery(
            f"{type(node).__name__} needs a distributed join; the cluster "
            f"executes single-anchor pipelines (scan -> filters -> "
            f"out-expands -> project/limit)")
    for op in chain:
        if isinstance(op, lp.Expand):
            if op.src != anchor or op.direction != "out":
                raise ClusterUnsupportedQuery(
                    f"expand ({op.src}){'<-' if op.direction == 'in' else '--'}"
                    f"({op.dst}) is not anchored at {anchor!r} going out: "
                    f"its edges live on another shard")
        else:
            _check_expr(op.predicate, anchor)
    if proj is not None:
        for item in proj.items:
            _check_expr(item.expr, anchor)
    return anchor


def _check_expr(expr: Any, anchor: str) -> None:
    if isinstance(expr, Prop):
        if expr.var != anchor and expr.key != "__self__":
            raise ClusterUnsupportedQuery(
                f"{expr.var}.{expr.key} reads a non-anchor node's property "
                f"(stored on its owner shard); only ids of expanded nodes "
                f"are shard-local")
        return
    if isinstance(expr, SubProp):
        if isinstance(expr.base, Prop):
            if expr.base.var != anchor:
                raise ClusterUnsupportedQuery(
                    f"{expr.base.var}.{expr.base.key}->{expr.sub_key} "
                    f"extracts φ of a non-anchor node's blob (stored on its "
                    f"owner shard)")
            return
        _check_expr(expr.base, anchor)      # query-side createFromSource(...)
        return
    if isinstance(expr, Compare):
        _check_expr(expr.left, anchor)
        _check_expr(expr.right, anchor)
        return
    if isinstance(expr, BoolOp):
        for a in expr.args:
            _check_expr(a, anchor)
        return
    if isinstance(expr, FuncCall):
        for a in expr.args:
            _check_expr(a, anchor)
        return
    # Literal / Param / plain values are shard-local by construction


def _and_conjuncts(expr: Any) -> Iterator[Any]:
    if isinstance(expr, BoolOp) and expr.op == "AND":
        for a in expr.args:
            yield from _and_conjuncts(a)
    elif expr is not None:
        yield expr


def id_bound_expr(q: MatchQuery, anchor: str) -> Optional[Any]:
    """The Literal/Param the anchor is pinned to by an AND-level
    ``anchor = <id>`` conjunct, or None -- the routed-lookup detector."""
    for c in _and_conjuncts(q.where):
        if not (isinstance(c, Compare) and c.op == "="):
            continue
        for a, b in ((c.left, c.right), (c.right, c.left)):
            if (isinstance(a, Prop) and a.var == anchor
                    and a.key == "__self__"
                    and isinstance(b, (Literal, Param))):
                return b
    return None


def resolve_id(expr: Any, params: Dict[str, Any]) -> int:
    if isinstance(expr, Literal):
        return int(expr.value)
    if isinstance(expr, Param):
        if expr.name not in params:
            raise KeyError(f"missing query parameter ${expr.name}")
        return int(params[expr.name])
    return int(expr)


def ordered_merge(streams: List[Iterator[Tuple[np.ndarray, List[Dict]]]],
                  batch_rows: int = 256,
                  limit: Optional[int] = None) -> Iterator[List[Dict]]:
    """K-way merge of tagged per-shard streams into global anchor-id order,
    yielding row batches of ~``batch_rows``.  Pulls a shard's next chunk
    only when its buffer drains (lazy: ``LIMIT`` stops the pulling), and
    closes every stream on exit -- normal exhaustion, early exit, or a
    caller abandoning the cursor all tear the shard pipelines down."""
    bufs: List[Optional[Tuple[np.ndarray, List[Dict], int]]] = \
        [None] * len(streams)

    def refill(s: int) -> bool:
        while True:
            nxt = next(streams[s], None)
            if nxt is None:
                bufs[s] = None
                return False
            ids, rows = nxt
            if rows:
                bufs[s] = (ids, rows, 0)
                return True

    heap: List[Tuple[int, int]] = []
    try:
        for s in range(len(streams)):
            if refill(s):
                heapq.heappush(heap, (int(bufs[s][0][0]), s))
        produced = 0
        out: List[Dict] = []
        while heap:
            _, s = heapq.heappop(heap)
            ids, rows, pos = bufs[s]
            out.append(rows[pos])
            produced += 1
            pos += 1
            if pos < len(rows):
                bufs[s] = (ids, rows, pos)
                heapq.heappush(heap, (int(ids[pos]), s))
            elif refill(s):
                heapq.heappush(heap, (int(bufs[s][0][0]), s))
            if limit is not None and produced >= limit:
                break
            if len(out) >= batch_rows:
                yield out
                out = []
        if out:
            yield out
    finally:
        close_streams(streams)


def close_streams(streams: List[Any]) -> None:
    """Close every per-shard iterator, even when one ``close()`` raises
    (a shard erroring mid-scatter must not leak the other shards' pipeline
    workers / in-flight φ batches).  The first close error is re-raised --
    unless an exception is already propagating (including the GeneratorExit
    of a cursor teardown), which keeps priority."""
    first: Optional[BaseException] = None
    for st in streams:
        close = getattr(st, "close", None)
        if close is None:
            continue
        try:
            close()
        except BaseException as e:  # noqa: BLE001 -- teardown must visit all
            if first is None:
                first = e
    if first is not None and sys.exc_info()[0] is None:
        raise first
