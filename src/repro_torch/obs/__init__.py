"""Unified observability: tracing spans, a metrics registry, and PROFILE.

Three layers:

- :mod:`.trace` — per-query span trees threaded Deadline-style through the
  session → executor → cluster → serving stack; off by default, near-zero
  cost when disabled; :func:`.trace.span` also mirrors spans onto the
  torch profiler's timeline while it records.
- :mod:`.metrics` — thread-safe counters / gauges / fixed-bucket latency
  histograms behind per-component registries, with JSON snapshot,
  Prometheus-style text dump, and a JSON-lines slow-query log.
- :mod:`.profile` — ``PROFILE <query>`` support: per-operator executed-plan
  annotation plus a cost-model predicted-vs-observed drift report.
"""

from .trace import Span, Trace, Tracer
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SlowQueryLog,
    global_snapshot,
    prometheus_dump,
)
from .profile import QueryProfile, format_profile

__all__ = [
    "Span",
    "Trace",
    "Tracer",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SlowQueryLog",
    "global_snapshot",
    "prometheus_dump",
    "QueryProfile",
    "format_profile",
]
