"""Estimating-cost-based greedy optimization (paper §V, Algorithm 1).

The optimizer receives the *query graph* (variables = nodes, relationship
patterns = edges) plus the WHERE predicates, and builds a plan bottom-up:

  1. PlanTable P starts with one leaf plan per query-graph node
     (NodeByLabelScan if the pattern has a label, else AllNodeScan).
  2. GreedyOrdering: candidates = join(P1,P2) for joinable pairs +
     expand(P1) along unused query-graph relationships + applicable filters.
  3. PickBest: min Est-cost candidate (EstModel = cost_model.estimate_cost).
  4. applySelections: any predicate whose vars are now covered *and* whose
     estimated filter cost is locally optimal is folded in; expensive
     semantic filters naturally sink to the end because their Est grows with
     input rows -- this is the paper's central optimization.
  5. Covered plans are removed.  Repeat until one plan covers Q.

CanJoin uses a union-find over shared variables (paper's complexity
analysis note), giving O(n^3) overall.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core import logical_plan as lp
from repro_torch.core.cost_model import StatisticsService, estimate_cost, estimate_plan_cost
from repro_torch.core.cypherplus import (
    BoolOp,
    Compare,
    MatchQuery,
    NodePattern,
    PathPattern,
    expr_vars,
    is_semantic,
)


@dataclasses.dataclass(frozen=True)
class QueryEdge:
    src: str
    dst: str
    rel_type: Optional[str]
    direction: str


@dataclasses.dataclass
class QueryGraph:
    nodes: Dict[str, NodePattern]
    edges: List[QueryEdge]
    predicates: List[Any]            # conjunctive WHERE terms

    @staticmethod
    def from_query(q: MatchQuery) -> "QueryGraph":
        nodes: Dict[str, NodePattern] = {}
        edges: List[QueryEdge] = []
        fresh = itertools.count()
        for pat in q.patterns:
            names = []
            for np_ in pat.nodes:
                var = np_.var or f"_anon{next(fresh)}"
                names.append(var)
                if var not in nodes or nodes[var].label is None:
                    nodes[var] = NodePattern(var, np_.label, np_.props)
            for i, rel in enumerate(pat.rels):
                edges.append(QueryEdge(names[i], names[i + 1], rel.rel_type,
                                       rel.direction))
        preds: List[Any] = []

        def flatten(e: Any) -> None:
            if isinstance(e, BoolOp) and e.op == "AND":
                for a in e.args:
                    flatten(a)
            elif e is not None:
                preds.append(e)

        flatten(q.where)
        # inline node-pattern property equalities as predicates
        from repro_torch.core.cypherplus import FuncCall, Literal, Param, Prop
        for var, np_ in nodes.items():
            for key, val in np_.props:
                if not isinstance(val, (Literal, Param, FuncCall)):
                    val = Literal(val)
                preds.append(Compare("=", Prop(var, key), val))
        return QueryGraph(nodes, edges, preds)


class _UnionFind:
    def __init__(self, items: Sequence[str]):
        self.parent = {x: x for x in items}

    def find(self, x: str) -> str:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: str, b: str) -> None:
        self.parent[self.find(a)] = self.find(b)


def _leaf_plan(np_: NodePattern) -> lp.PlanOp:
    if np_.label:
        return lp.NodeByLabelScan(np_.var, np_.label)
    return lp.AllNodeScan(np_.var)


def _filter_op(child: lp.PlanOp, pred: Any, pred_id: int,
               accuracy: Optional[float] = None) -> lp.PlanOp:
    if is_semantic(pred):
        # accuracy 1.0 is exact-only: normalize to None so the plan (and its
        # cost-model op_key) is structurally identical to the no-clause query
        acc = accuracy if accuracy is not None and accuracy < 1.0 else None
        return lp.SemanticFilter(child, pred, pred_id, acc)
    return lp.Filter(child, pred, pred_id)


def optimize(qg: QueryGraph, stats: StatisticsService,
             accuracy: Optional[float] = None) -> lp.PlanOp:
    """Algorithm 1: OptimizationFunc(Q, S)."""
    # PlanTable
    table: List[lp.PlanOp] = [_leaf_plan(np_) for np_ in qg.nodes.values()]
    unused_edges: Set[int] = set(range(len(qg.edges)))
    unapplied: Dict[int, Any] = dict(enumerate(qg.predicates))

    def covered_edges_done() -> bool:
        return not unused_edges and len(table) == 1 and not unapplied

    def candidates() -> List[Tuple[float, str, Any]]:
        cand: List[Tuple[float, str, Any]] = []
        # joins of pairs sharing variables (CanJoin via union-find)
        for i, p1 in enumerate(table):
            for j, p2 in enumerate(table):
                if i >= j:
                    continue
                if p1.vars & p2.vars:
                    op = lp.Join(p1, p2)
                    cand.append((estimate_cost(op, stats), "join", (i, j, op)))
        # expands along unused query-graph relationships
        for i, p1 in enumerate(table):
            for eid in unused_edges:
                e = qg.edges[eid]
                for src, dst, direction in ((e.src, e.dst, e.direction),
                                            (e.dst, e.src, _flip(e.direction))):
                    if src in p1.vars and dst not in p1.vars:
                        op = lp.Expand(p1, src, dst, e.rel_type, direction)
                        cand.append((estimate_cost(op, stats), "expand",
                                     (i, eid, op)))
                # expand-into (both endpoints bound): treat as filter-join
                if e.src in p1.vars and e.dst in p1.vars:
                    op = lp.Expand(p1, e.src, e.dst, e.rel_type, e.direction)
                    cand.append((estimate_cost(op, stats), "expand",
                                 (i, eid, op)))
        # applicable predicates
        for pid, pred in unapplied.items():
            vars_needed = expr_vars(pred)
            for i, p1 in enumerate(table):
                if vars_needed <= p1.vars:
                    op = _filter_op(p1, pred, pid, accuracy)
                    cand.append((estimate_cost(op, stats), "filter",
                                 (i, pid, op)))
        return cand

    guard = 0
    while True:
        guard += 1
        if guard > 10_000:
            raise RuntimeError("optimizer did not converge")
        cand = candidates()
        if not cand:
            break
        # PickBest: min estimated cost (ties: prefer filters -- they shrink T)
        prio = {"filter": 0, "expand": 1, "join": 2}
        cost, kind, payload = min(cand, key=lambda c: (c[0], prio[c[1]]))
        if kind == "join":
            i, j, op = payload
            table = [p for k, p in enumerate(table) if k not in (i, j)]
            table.append(op)
        elif kind == "expand":
            i, eid, op = payload
            table[i] = op
            unused_edges.discard(eid)
            # remove plans now covered by the best plan (AllNodeScan of dst)
            table = [p for p in table
                     if p is op or not (p.vars <= op.vars and _is_bare_scan(p))]
        else:  # filter
            i, pid, op = payload
            table[i] = op
            del unapplied[pid]
        if covered_edges_done():
            break

    # join any disconnected remainder (cross product)
    while len(table) > 1:
        a, b = table[0], table[1]
        table = table[2:] + [lp.Join(a, b)]
    plan = table[0]
    # any leftover predicates (vars now all covered)
    for pid, pred in list(unapplied.items()):
        plan = _filter_op(plan, pred, pid, accuracy)
        del unapplied[pid]
    return plan


def _flip(direction: str) -> str:
    return {"out": "in", "in": "out", "any": "any"}[direction]


def _is_bare_scan(p: lp.PlanOp) -> bool:
    return isinstance(p, (lp.AllNodeScan, lp.NodeByLabelScan))


def naive_plan(qg: QueryGraph, stats: StatisticsService,
               accuracy: Optional[float] = None) -> lp.PlanOp:
    """The 'Not optimized' baseline (paper §VII-F): semantic filters treated
    as ordinary structured filters -- i.e. applied as early as possible."""
    table: List[lp.PlanOp] = [_leaf_plan(np_) for np_ in qg.nodes.values()]
    unapplied = dict(enumerate(qg.predicates))
    # apply every predicate as soon as its vars are covered, semantic first
    def apply_eager():
        changed = True
        while changed:
            changed = False
            for pid, pred in sorted(list(unapplied.items()),
                                    key=lambda kv: not is_semantic(kv[1])):
                for i, p in enumerate(table):
                    if expr_vars(pred) <= p.vars:
                        table[i] = _filter_op(p, pred, pid, accuracy)
                        del unapplied[pid]
                        changed = True
                        break
                if changed:
                    break

    apply_eager()
    unused = list(range(len(qg.edges)))
    guard = 0
    while unused and guard < 1000:
        guard += 1
        for eid in list(unused):
            e = qg.edges[eid]
            done = False
            for i, p in enumerate(table):
                if e.src in p.vars and e.dst not in p.vars:
                    table[i] = lp.Expand(p, e.src, e.dst, e.rel_type, e.direction)
                    done = True
                elif e.dst in p.vars and e.src not in p.vars:
                    table[i] = lp.Expand(p, e.dst, e.src, e.rel_type,
                                         _flip(e.direction))
                    done = True
                if done:
                    # drop bare scans covered by the expansion
                    table[:] = [q for q in table
                                if q is table[i] or not (
                                    q.vars <= table[i].vars and _is_bare_scan(q))]
                    break
            if done:
                unused.remove(eid)
                apply_eager()
    while len(table) > 1:
        a, b = table[0], table[1]
        table = table[2:] + [lp.Join(a, b)]
    plan = table[0]
    for pid, pred in list(unapplied.items()):
        plan = _filter_op(plan, pred, pid, accuracy)
    return plan
