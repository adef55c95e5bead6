"""Unified metrics: thread-safe counters, gauges, and fixed-bucket latency
histograms behind one registry, with JSON / Prometheus-style exporters and a
JSON-lines slow-query log.

The registry absorbs the counter dicts that used to live in
``cluster/coordinator.py``, ``cluster/replication.py`` and
``serving/engine.py``; those modules keep their public read views
(``explain()["counters"]``, ``route_counts()``) byte-compatible by reading
back out of the registry.

Each coordinator / server owns its own :class:`MetricsRegistry` instance so
independent clusters in one process don't cross-pollute; every instance also
registers itself on a process-wide roster so :func:`global_snapshot` can see
everything at once (the ``--metrics`` dump in ``launch/serve.py``).
"""

from __future__ import annotations

import bisect
import json
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional

# Default latency buckets (milliseconds): 0.1 ms .. 30 s, roughly 2x steps.
DEFAULT_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000,
)


class Counter:
    """Monotonic counter.  ``inc`` is a lock-guarded read-modify-write so
    concurrent increments from hedge pools / worker threads never lose
    updates (the old ``dict[k] += 1`` path could)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    """Point-in-time value (queue depth, alive replicas, ...)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._v += dv

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket latency histogram with percentile readout.

    Buckets are upper bounds (inclusive) plus an implicit +Inf bucket.
    Percentiles interpolate within the winning bucket, which is plenty for
    p50/p95/p99 dashboards and avoids keeping raw samples.
    """

    __slots__ = ("name", "buckets", "_counts", "_sum", "_n", "_lock")

    def __init__(self, name: str, buckets: Iterable[float] = DEFAULT_BUCKETS_MS):
        self.name = name
        self.buckets: List[float] = sorted(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile (p in [0, 100])."""
        with self._lock:
            n = self._n
            counts = list(self._counts)
        if n == 0:
            return 0.0
        target = max(1, int(round(p / 100.0 * n)))
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= target:
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1] * 2
                lo = self.buckets[i - 1] if i > 0 else 0.0
                frac = (target - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.buckets[-1] * 2

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.sum, 4),
            "p50": round(self.percentile(50), 4),
            "p95": round(self.percentile(95), 4),
            "p99": round(self.percentile(99), 4),
        }


_all_registries: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()


class MetricsRegistry:
    """Create-on-demand registry of counters / gauges / histograms."""

    def __init__(self, namespace: str = "repro"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        _all_registries.add(self)

    # -- instrument factories (create-on-first-use, then cached) --------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str, buckets: Iterable[float] = DEFAULT_BUCKETS_MS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name, buckets))
        return h

    # -- back-compat views ---------------------------------------------
    def counters_view(self, prefix: str = "") -> Dict[str, int]:
        """Flat ``{short_name: value}`` dict of counters under ``prefix``
        (prefix stripped) — the shape the old hand-rolled dicts had."""
        out: Dict[str, int] = {}
        with self._lock:
            items = list(self._counters.items())
        for name, c in items:
            if name.startswith(prefix):
                out[name[len(prefix):]] = c.value
        return out

    # -- exporters ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot of every instrument."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        return {
            "namespace": self.namespace,
            "counters": {n: c.value for n, c in sorted(counters)},
            "gauges": {n: g.value for n, g in sorted(gauges)},
            "histograms": {n: h.summary() for n, h in sorted(hists)},
        }

    def prometheus_text(self) -> str:
        """Prometheus-style text exposition (counters, gauges, histograms
        with cumulative buckets)."""
        ns = self.namespace
        lines: List[str] = []

        def sanitize(name: str) -> str:
            return "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)

        snap = self.snapshot()
        for name, v in snap["counters"].items():
            m = f"{ns}_{sanitize(name)}_total"
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {v}")
        for name, v in snap["gauges"].items():
            m = f"{ns}_{sanitize(name)}"
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {v}")
        with self._lock:
            hists = list(self._hists.items())
        for name, h in hists:
            m = f"{ns}_{sanitize(name)}"
            lines.append(f"# TYPE {m} histogram")
            with h._lock:
                counts = list(h._counts)
                total = h._n
                s = h._sum
            cum = 0
            for ub, c in zip(h.buckets, counts):
                cum += c
                lines.append(f'{m}_bucket{{le="{ub}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{m}_sum {round(s, 4)}")
            lines.append(f"{m}_count {total}")
        return "\n".join(lines) + "\n"


def global_snapshot() -> List[Dict[str, Any]]:
    """Snapshots of every live registry in the process."""
    return [r.snapshot() for r in list(_all_registries)]


def prometheus_dump() -> str:
    """Prometheus-style exposition of every live registry (the
    ``--metrics`` scrape surface in ``launch/serve.py``)."""
    regs = sorted(_all_registries, key=lambda r: r.namespace)
    return "".join(r.prometheus_text() for r in regs)


class SlowQueryLog:
    """Per-query JSON-lines slow-query log with a threshold knob.

    One line per offending query: text, total/queue milliseconds, rows,
    error, degradations, trace id.  Written by the serving engine."""

    def __init__(self, path: str, threshold_ms: float):
        self.path = path
        self.threshold_ms = float(threshold_ms)
        self._lock = threading.Lock()

    def maybe_log(self, *, text: str, total_ms: float, queue_ms: float = 0.0,
                  rows: int = 0, error: Optional[str] = None,
                  degradations: Iterable[str] = (),
                  trace_id: Optional[str] = None) -> bool:
        if total_ms < self.threshold_ms:
            return False
        rec = {
            "ts": round(time.time(), 3),
            "text": text,
            "total_ms": round(total_ms, 3),
            "queue_ms": round(queue_ms, 3),
            "rows": rows,
            "error": error,
            "degradations": list(degradations),
            "trace_id": trace_id,
        }
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        return True
