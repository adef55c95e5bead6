"""PROFILE support: per-operator execution accounting + cost-model drift.

A :class:`QueryProfile` is created per profiled query and threaded through
the execution context exactly like ``Deadline`` / ``Trace``.  The executor's
``_record`` choke point feeds it one ``note()`` per operator invocation
(plan-node identity, measured wall time, rows in/out).  Because the cluster
coordinator hands the *same* plan tree to every shard stream, per-node
accumulation aggregates across shards and replica retries for free.

At creation time the profile captures the cost model's *predicted* cost per
operator (``estimate_cost``, Definition 5.1) so ``report()`` can emit a
``drift`` section — predicted vs observed seconds and their ratio per op
key — the optimizer EWMAs' first ground-truth audit.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from . import trace as _trace_mod

# ExecutionContext counters folded into the φ section of the report.
_CTX_COUNTERS = (
    "extract_count", "dedup_borrows", "phi_coalesced", "index_hits",
    "scan_rows", "proxy_scored", "proxy_hits", "escalated_rows",
    "cascade_chunks",
)

# Trace span/event names surfaced as headline event counts.
_EVENT_NAMES = (
    "hedge.fire", "hedge.win", "hedge.loser_reap", "failover", "retry",
    "replica.pick", "phi.dispatch", "phi.cache_hit", "cascade.proxy_score",
    "cascade.escalate", "degradation", "shed", "drop",
)


class QueryProfile:
    """Thread-safe per-operator accounting for one profiled query."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # id(plan_node) -> {"op": node, "key": str, "calls", "rows_in",
        #                   "rows_out", "time_s"}
        self._per_node: Dict[int, Dict[str, Any]] = {}
        # op_key -> predicted seconds (captured before execution)
        self._predicted: Dict[str, float] = {}
        self._ctxs: List[Any] = []
        self._shards: set = set()

    # -- wiring ---------------------------------------------------------
    def capture_predictions(self, plan: Any, stats: Any) -> None:
        """Record the cost model's per-operator estimates *before* running."""
        from ..core import cost_model as _cm
        from ..core import logical_plan as lp

        for op in lp.plan_ops(plan):
            key = stats.op_key(op)
            try:
                pred = float(_cm.estimate_cost(op, stats))
            except Exception:
                pred = 0.0
            with self._lock:
                self._predicted[key] = self._predicted.get(key, 0.0) + pred

    def register_ctx(self, ctx: Any) -> None:
        """Called by ExecutionContext so φ/cache counters from every shard
        stream (and replica retry) are summed into the report."""
        with self._lock:
            self._ctxs.append(ctx)

    def note(self, op: Any, key: str, dt: float, rows_in: int,
             rows_out: Optional[int] = None) -> None:
        """One operator invocation: ``dt`` seconds over ``rows_in`` rows."""
        with self._lock:
            ent = self._per_node.get(id(op))
            if ent is None:
                ent = {"op": op, "key": key, "calls": 0, "rows_in": 0,
                       "rows_out": 0, "time_s": 0.0}
                self._per_node[id(op)] = ent
            ent["calls"] += 1
            ent["rows_in"] += int(rows_in)
            if rows_out is not None:
                ent["rows_out"] += int(rows_out)
            ent["time_s"] += float(dt)

    def note_shard(self, shard: Any) -> None:
        with self._lock:
            self._shards.add(shard)

    # -- report ---------------------------------------------------------
    def _annotate(self, plan: Any) -> Dict[str, Any]:
        ent = self._per_node.get(id(plan))
        node: Dict[str, Any] = {
            "op": type(plan).__name__,
            "args": plan._describe_args(),
        }
        if ent is not None:
            node.update({
                "key": ent["key"],
                "calls": ent["calls"],
                "rows_in": ent["rows_in"],
                "rows_out": ent["rows_out"],
                "time_ms": round(ent["time_s"] * 1e3, 3),
            })
        node["children"] = [self._annotate(c) for c in plan.children()]
        return node

    def drift(self) -> Dict[str, Dict[str, float]]:
        """Predicted-vs-observed seconds per op key.  ``ratio`` > 1 means
        the cost model over-estimated that operator."""
        with self._lock:
            predicted = dict(self._predicted)
            per_node = list(self._per_node.values())
        observed: Dict[str, float] = {}
        for ent in per_node:
            observed[ent["key"]] = observed.get(ent["key"], 0.0) + ent["time_s"]
        out: Dict[str, Dict[str, float]] = {}
        for key in sorted(set(predicted) | set(observed)):
            p = predicted.get(key, 0.0)
            o = observed.get(key, 0.0)
            out[key] = {
                "predicted_s": round(p, 6),
                "observed_s": round(o, 6),
                "ratio": round(p / o, 3) if o > 0 else float("inf") if p > 0 else 1.0,
            }
        return out

    def report(self, plan: Any, trace: Optional["_trace_mod.Trace"] = None,
               deadline: Any = None, include_trace: bool = False) -> Dict[str, Any]:
        """The PROFILE payload: annotated executed plan + φ accounting +
        cluster events + drift + span coverage."""
        with self._lock:
            ctxs = list(self._ctxs)
            shards = sorted(self._shards)
        phi = {name: sum(getattr(c, name, 0) for c in ctxs) for name in _CTX_COUNTERS}
        out: Dict[str, Any] = {
            "plan": self._annotate(plan),
            "phi": phi,
            "shards_touched": shards,
            "drift": self.drift(),
        }
        if trace is not None:
            trace.finish()
            events = {name: 0 for name in _EVENT_NAMES}
            for sp in trace.root.walk():
                if sp.name in events:
                    events[sp.name] += 1
            out["events"] = {k: v for k, v in events.items() if v}
            out["trace_id"] = trace.trace_id
            out["wall_ms"] = round(trace.root.duration_s * 1e3, 3)
            out["span_coverage"] = round(trace.coverage(), 4)
            out["well_nested"] = trace.well_nested()
            if include_trace:
                out["trace"] = trace.to_dict()
        if deadline is not None:
            out["degradations"] = list(deadline.degradations)
            out["approximate"] = bool(deadline.approximate)
        return out


def format_profile(report: Dict[str, Any]) -> str:
    """Human-readable rendering of a ``report()`` dict (README example)."""
    lines: List[str] = []

    def walk(node: Dict[str, Any], depth: int) -> None:
        pad = "  " * depth
        head = f"{pad}{node['op']}{node.get('args', '')}"
        if "time_ms" in node:
            head += (f"  rows_in={node['rows_in']} rows_out={node['rows_out']}"
                     f" calls={node['calls']} time={node['time_ms']}ms")
        lines.append(head)
        for c in node.get("children", ()):
            walk(c, depth + 1)

    walk(report["plan"], 0)
    if report.get("events"):
        lines.append("events: " + ", ".join(f"{k}={v}" for k, v in sorted(report["events"].items())))
    if report.get("degradations"):
        lines.append("degradations: " + ", ".join(report["degradations"]))
    if "wall_ms" in report:
        lines.append(f"wall={report['wall_ms']}ms span_coverage={report['span_coverage']:.1%}")
    lines.append("drift (predicted/observed per op key):")
    for key, d in report["drift"].items():
        lines.append(f"  {key}: pred={d['predicted_s'] * 1e3:.3f}ms "
                     f"obs={d['observed_s'] * 1e3:.3f}ms ratio={d['ratio']}")
    return "\n".join(lines)
