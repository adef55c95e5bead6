"""Lightweight query tracing: spans, traces, and a near-zero-cost off switch.

Design contract:

- Tracing is OFF by default.  Instrumentation sites hold a ``trace``
  reference that is ``None`` when disabled, so the disabled cost is one
  attribute load + identity check per site — no allocation, no call.
- A :class:`Trace` is created per query and threaded through the stack
  exactly like ``Deadline``: one shared object handed to the execution
  context, shard streams, hedge legs, and the serving engine.
- Timestamps come from ``time.perf_counter()`` (monotonic).  Spans nest
  per-thread via a thread-local stack; work that hops threads (shard
  scatter pools, hedge legs, AIPM callbacks) attaches children with an
  explicit ``parent=`` handle.
- That clock is not the device's.  :func:`span` mirrors a span onto the
  torch profiler's timeline, whose clock every kernel, copy and idle gap
  shares, as a ``record_function`` range while the profiler records, on
  any thread (a profiler that records every thread sees a worker's, the
  AIPM service's φ calls); with neither a trace nor the profiler it
  costs one call and two checks.
  :func:`phases` does the same for a span of consecutive steps, at one
  truth test a step when nothing records.
- Spans are always closed: ``__exit__`` runs on any exception and stamps
  the error type on the span before re-raising.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_perf = time.perf_counter
_profiler_enabled = torch._C._autograd._profiler_enabled


def _recording() -> bool:
    """Whether a torch profiler records: one started on this thread, or on
    another (this thread's ranges are then recorded where it profiles
    every thread; elsewhere they cost their calls and are dropped)."""
    return _autograd_profiler._is_profiler_enabled or _profiler_enabled()
_trace_ids = itertools.count(1)


class Span:
    """One timed interval in a trace tree.  Not created directly — use
    ``trace.span(...)`` / ``trace.event(...)`` / ``trace.add_timed(...)``."""

    __slots__ = ("name", "attrs", "t0", "t1", "parent", "children")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]], parent: Optional["Span"]):
        self.name = name
        # the dict is owned by the caller (Trace builds it from **attrs) —
        # adopt it without copying; spans are on the per-operator hot path
        self.attrs: Dict[str, Any] = attrs if attrs is not None else {}
        self.t0: float = 0.0
        self.t1: Optional[float] = None
        self.parent = parent
        self.children: List["Span"] = []

    @property
    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else _perf()
        return max(0.0, end - self.t0)

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "t0": self.t0,
            "dur_ms": round(self.duration_s * 1e3, 4),
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "open" if self.t1 is None else f"{self.duration_s * 1e3:.2f}ms"
        return f"Span({self.name!r}, {state}, attrs={self.attrs!r})"


class _SpanCtx:
    """Context manager returned by ``Trace.span``.  Closes the span on any
    exit path and records the exception type if one escaped."""

    __slots__ = ("_trace", "_span")

    def __init__(self, trace: "Trace", span: Span):
        self._trace = trace
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.attrs["error"] = exc_type.__name__
        self._trace._close(self._span)
        return False


class Trace:
    """Per-query span tree.  Thread-safe child attachment; per-thread
    nesting via a thread-local span stack."""

    def __init__(self, name: str = "query", trace_id: Optional[str] = None, **attrs: Any):
        self.trace_id = trace_id or f"t{next(_trace_ids):08x}"
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.root = Span(name, attrs, None)
        self.root.t0 = _perf()

    # -- nesting helpers ------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def current(self) -> Span:
        st = self._stack()
        return st[-1] if st else self.root

    def _open(self, name: str, attrs: Dict[str, Any], parent: Optional[Span]) -> Span:
        sp = Span(name, attrs, None)
        sp.t0 = _perf()
        with self._lock:
            if self.root.t1 is not None:
                # late arrival (hedge loser leg, reaper callback) after the
                # query finished: keep the span detached so a completed
                # trace can never lose well-nestedness to a straggler
                return sp
            sp.parent = parent if parent is not None else self.current()
            sp.parent.children.append(sp)
        self._stack().append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        with self._lock:
            if sp.t1 is None:       # finish() may have truncated it already
                end = _perf()
                if sp.parent is not None and self.root.t1 is not None:
                    # straggler closing after the query end: truncate there
                    end = min(end, self.root.t1)
                sp.t1 = max(sp.t0, end)
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:  # closed out of order (shouldn't happen) — recover
            st.remove(sp)

    # -- public API -----------------------------------------------------
    def span(self, name: str, parent: Optional[Span] = None, **attrs: Any) -> _SpanCtx:
        """``with trace.span("op", k=v) as sp: ...`` — nested, always closed."""
        return _SpanCtx(self, self._open(name, attrs, parent))

    def event(self, name: str, parent: Optional[Span] = None, **attrs: Any) -> Span:
        """Zero-duration child span marking an instant (hedge fired, shed, ...)."""
        sp = Span(name, attrs, None)
        sp.t0 = sp.t1 = _perf()
        with self._lock:
            if self.root.t1 is not None:
                return sp               # late arrival: detached
            sp.parent = parent if parent is not None else self.current()
            sp.parent.children.append(sp)
        return sp

    def add_timed(self, name: str, dt_s: float, parent: Optional[Span] = None,
                  **attrs: Any) -> Span:
        """Record an already-measured interval ending now (used by operator
        kernels that time themselves and report after the fact)."""
        sp = Span(name, attrs, None)
        sp.t1 = _perf()
        sp.t0 = sp.t1 - max(0.0, dt_s)
        with self._lock:
            if self.root.t1 is not None:
                return sp               # late arrival: detached
            sp.parent = parent if parent is not None else self.current()
            sp.parent.children.append(sp)
        return sp

    def finish(self) -> None:
        """Close the root (idempotent), truncating any span still open —
        e.g. a hedge loser leg mid-pull when the winner completed the
        query — at the query end.  Called at cursor exhaustion/close."""
        with self._lock:
            if self.root.t1 is not None:
                return
            self.root.t1 = _perf()
            for sp in self.root.walk():
                if sp.t1 is None:
                    sp.t1 = self.root.t1
                    sp.attrs["truncated"] = True

    # -- inspection -----------------------------------------------------
    def spans(self) -> List[Span]:
        return list(self.root.walk())

    def find(self, name: str) -> List[Span]:
        return [s for s in self.root.walk() if s.name == name]

    def well_nested(self) -> bool:
        """Every span closed, inside its parent's interval, monotone."""
        for s in self.root.walk():
            if s.t1 is None or s.t1 < s.t0:
                return False
            if s.parent is not None:
                p = s.parent
                if s.t0 < p.t0 - 1e-6 or (p.t1 is not None and s.t1 > p.t1 + 1e-6):
                    return False
        return True

    def coverage(self) -> float:
        """Fraction of the root's wall time covered by the union of its
        direct children's intervals.  The PROFILE acceptance gate."""
        total = self.root.duration_s
        if total <= 0.0:
            return 1.0
        end0 = self.root.t1 if self.root.t1 is not None else _perf()
        ivals = sorted(
            (max(c.t0, self.root.t0), min(c.t1 if c.t1 is not None else end0, end0))
            for c in self.root.children
        )
        covered = 0.0
        cur_lo = cur_hi = None
        for lo, hi in ivals:
            if hi <= lo:
                continue
            if cur_lo is None:
                cur_lo, cur_hi = lo, hi
            elif lo <= cur_hi:
                cur_hi = max(cur_hi, hi)
            else:
                covered += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
        if cur_lo is not None:
            covered += cur_hi - cur_lo
        return min(1.0, covered / total)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "root": self.root.to_dict()}


class _NullSpan:
    """What :func:`span` gives when nothing records: a context manager
    that enters as itself and drops attributes.  One shared instance."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _ProfiledSpan:
    """A ``record_function`` range on the profiler's timeline, with the
    trace's span inside it when a trace is given (the range's ``args``
    then carry the trace id)."""

    __slots__ = ("_range", "_span")

    def __init__(self, trace: Optional[Trace], name: str,
                 attrs: Dict[str, Any]):
        self._range = torch.autograd.profiler.record_function(
            name, None if trace is None else trace.trace_id)
        self._span = None if trace is None else trace.span(name, **attrs)

    def __enter__(self):
        self._range.__enter__()
        return NULL_SPAN if self._span is None else self._span.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if self._span is not None:
                self._span.__exit__(exc_type, exc, tb)
        finally:
            self._range.__exit__(exc_type, exc, tb)
        return False


def span(trace: Optional[Trace], name: str, **attrs: Any):
    """``with span(trace, "op", k=v) as sp: ...``: ``trace.span`` when a
    trace is given, mirrored as a profiler range while the torch profiler
    records, and :data:`NULL_SPAN` when neither (no ``record_function``,
    nothing allocated).  ``sp.set(...)`` works on all three."""
    if _recording():
        return _ProfiledSpan(trace, name, attrs)
    if trace is None:
        return NULL_SPAN
    return trace.span(name, **attrs)


class _NullPhases:
    """What :func:`phases` gives when nothing records: enters as None."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_PHASES = _NullPhases()


class Phases:
    """A :func:`span` whose children run one after another (see
    :func:`phases`).  ``span`` is the span itself, for its attributes."""

    __slots__ = ("_trace", "_outer", "span", "_child", "_child_sp")

    def __init__(self, trace: Optional[Trace], name: str,
                 attrs: Dict[str, Any]):
        self._trace = trace
        self._outer = span(trace, name, **attrs)
        self._child = None

    def __enter__(self) -> "Phases":
        self.span = self._outer.__enter__()
        return self

    def next(self, name: str, **attrs: Any) -> None:
        """End the running child, if any, and start ``name``."""
        self._end(None, None, None)
        self._child = span(self._trace, name, **attrs)
        self._child_sp = self._child.__enter__()

    def set(self, **attrs: Any) -> None:
        """Attributes of the running child."""
        self._child_sp.set(**attrs)

    def _end(self, exc_type, exc, tb) -> None:
        child, self._child = self._child, None
        if child is not None:
            child.__exit__(exc_type, exc, tb)

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            self._end(exc_type, exc, tb)
        finally:
            self._outer.__exit__(exc_type, exc, tb)
        return False


def phases(trace: Optional[Trace], name: str, **attrs: Any):
    """``with phases(trace, "op", k=v) as ph: ...``: the span :func:`span`
    opens, whose children follow one another: ``if ph: ph.next("step")``
    ends the running child and starts the next, and the exit ends the last
    (an escaping error is stamped on both).  ``ph`` is None when nothing
    records, so that a site costs one truth test: a hot path with many
    steps pays no call, no ``with`` and no allocation a step."""
    if trace is None and not _recording():
        return _NULL_PHASES
    return Phases(trace, name, attrs)


class Tracer:
    """Trace factory hung off a database / coordinator / server.  Disabled
    (the default) it hands out ``None``, which every instrumentation site
    treats as "don't trace" — the near-zero-overhead contract."""

    __slots__ = ("enabled", "_keep", "last")

    def __init__(self, enabled: bool = False, keep_last: bool = True):
        self.enabled = enabled
        self._keep = keep_last
        self.last: Optional[Trace] = None

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def begin(self, name: str = "query", force: bool = False, **attrs: Any) -> Optional[Trace]:
        """Start a per-query trace, or ``None`` when tracing is off.
        ``force=True`` (used by PROFILE) traces regardless of the switch."""
        if not self.enabled and not force:
            return None
        tr = Trace(name, **attrs)
        if self._keep:
            self.last = tr
        return tr
