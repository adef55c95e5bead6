"""Driver-style query surface: sessions, prepared statements, plan cache,
streaming cursors (the prepare/bind/execute split real graph drivers expose).

The seed exposed one monolithic ``PandaDB.query(text)`` that re-parsed and
re-optimized every request and materialized all rows eagerly.  This module
layers the client API the ROADMAP's traffic targets need:

* :class:`Session`            -- ``db.session()``; ``run()`` / ``prepare()``
  plus explicit :meth:`Session.read_transaction` /
  :meth:`Session.write_transaction` scoping over the WAL.
* :class:`PreparedStatement`  -- parsed once; ``$param`` placeholders bound
  per :meth:`PreparedStatement.run`, so one optimized plan serves every
  binding of the skeleton.
* :class:`PlanCache`          -- process-wide (shared via ``db.plan_cache``),
  keyed by ``(query skeleton, optimized, statistics epoch)`` with hit/miss
  counters surfaced through ``explain()``.  A statistics refresh that
  observes changed graph cardinalities bumps the epoch and invalidates
  entries naturally (stale keys age out of the LRU).
* :class:`Cursor`             -- lazily streams projected rows in bounded
  batches through :func:`repro_torch.core.executor.execute_iter`; ``LIMIT n``
  stops pulling from the scan pipeline after ``n`` rows (early exit).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import logical_plan as lp
from repro_torch.core.cypherplus import (
    CreateQuery,
    MatchQuery,
    Query,
    parse_query,
    query_params,
)
from repro_torch.core.deadline import Deadline
from repro_torch.core.executor import (
    DEFAULT_BATCH_ROWS,
    ExecutionContext,
    execute_iter,
)
from repro_torch.core.plan_optimizer import QueryGraph, naive_plan, optimize
from repro_torch.obs import QueryProfile
from repro_torch.obs.trace import Trace


def _segments(text: str) -> Iterator[Tuple[bool, str]]:
    """Split query text into ``(is_quoted, segment)`` pairs.  Quoted
    segments include their quotes and are the single source of truth for
    "what counts as a string literal" for both the plan-cache skeleton and
    WAL statement rendering."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "'\"":
            j = text.find(c, i + 1)
            j = n - 1 if j < 0 else j       # unterminated: rest is literal
            yield True, text[i:j + 1]
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in "'\"":
                j += 1
            yield False, text[i:j]
            i = j


_WS_RE = re.compile(r"\s+")


def skeleton_of(text: str) -> str:
    """Whitespace-normalized query text: the plan-cache identity.  Literal
    values stay part of the skeleton (whitespace *inside* quoted strings is
    preserved, so ``'a b'`` and ``'a  b'`` stay distinct queries) -- use
    ``$param`` placeholders to share one plan across bindings."""
    return "".join(seg if quoted else _WS_RE.sub(" ", seg)
                   for quoted, seg in _segments(text)).strip()


_PARAM_RE = re.compile(r"\$[A-Za-z_][A-Za-z0-9_]*")


_NUM_LITERAL_RE = re.compile(r"\d+\.\d+|\d+")


def render_scalar(v: Any) -> Optional[str]:
    """Render a param value as a CypherPlus literal the lexer can re-parse,
    or None if it cannot be represented faithfully (quotes in strings,
    negative numbers, exponent floats, bytes...).  Numpy scalars render
    like their Python counterparts."""
    if isinstance(v, (bool, np.bool_)):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        if "'" in v or '"' in v or "\n" in v:
            return None
        return "'" + v + "'"
    if isinstance(v, (int, np.integer)):
        v = int(v)
        return str(v) if v >= 0 else None
    if isinstance(v, (float, np.floating)):
        s = repr(float(v))
        return s if _NUM_LITERAL_RE.fullmatch(s) else None
    return None


def check_wal_renderable(q: Query, params: Dict[str, Any]) -> None:
    """Raise if any bound param of ``q`` has no WAL-replayable literal form.
    Runs when a write is accepted (defer time for transactions), so a bad
    value aborts before anything is applied or queued behind it."""
    for name in sorted(query_params(q)):
        if name in params and render_scalar(params[name]) is None:
            raise ValueError(
                f"parameter ${name} ({type(params[name]).__name__}) has no "
                f"WAL-replayable literal form; write strings without quotes "
                f"/ non-negative numbers, or reference file content via "
                f"createFromSource($path)")


def bind_text(text: str, params: Dict[str, Any]) -> str:
    """Inline scalar parameter values into a statement (WAL replayability:
    followers replay logged statements without the bind-time param map).
    ``$name`` sequences inside quoted string literals are left untouched
    (they are string content, not placeholders).  Values with no faithful
    literal form (bytes, arrays, strings containing quotes, negative or
    exponent numbers) keep their placeholder -- replay then fails loudly on
    the missing param rather than silently diverging."""
    if not params:
        return text.strip()

    def repl(m: "re.Match[str]") -> str:
        name = m.group(0)[1:]
        if name not in params:
            return m.group(0)
        rendered = render_scalar(params[name])
        return m.group(0) if rendered is None else rendered

    return "".join(seg if quoted else _PARAM_RE.sub(repl, seg)
                   for quoted, seg in _segments(text)).strip()


# ---------------------------------------------------------------------------
# locking: statement-level writer exclusion + transaction scoping
# ---------------------------------------------------------------------------


class RWLock:
    """Many concurrent readers, one exclusive writer (leader serialization
    for writing-queries, paper §VII-A).

    * The thread holding the write side may freely take the read side
      (reads inside a write-transaction scope -- e.g. ``db.query()`` through
      a second session -- must not deadlock against their own transaction).
    * Read acquisition is reentrant per thread, so a read inside an open
      read scope never waits (it could deadlock against a queued writer).
    * A queued writer gates *new* first reads (no reader-preference
      starvation under sustained cursor traffic).
    * Write acquisition is not reentrant and cannot upgrade a read --
      both raise immediately instead of hanging."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._reader_counts: Dict[int, int] = {}   # thread id -> held reads
        self._writer = False
        self._writer_thread: Optional[int] = None
        self._writer_reads = 0      # read re-entries by the writer thread
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer and self._writer_thread == me:
                self._writer_reads += 1
                return
            if me in self._reader_counts:           # reentrant read
                self._reader_counts[me] += 1
                return
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._reader_counts[me] = 1

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer and self._writer_thread == me \
                    and self._writer_reads > 0:
                self._writer_reads -= 1
                return
            cnt = self._reader_counts.get(me, 0)
            if cnt <= 1:
                self._reader_counts.pop(me, None)
            else:
                self._reader_counts[me] = cnt - 1
            if not self._reader_counts:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer and self._writer_thread == me:
                raise RuntimeError(
                    "write lock is not reentrant: this thread already holds "
                    "a write transaction -- run the statement through it")
            if me in self._reader_counts:
                raise RuntimeError(
                    "cannot upgrade a read lock to a write lock: finish the "
                    "read transaction before writing")
            self._writers_waiting += 1
            try:
                while self._writer or self._reader_counts:
                    self._cond.wait()
                self._writer = True
                self._writer_thread = me
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._writer_thread = None
            self._writer_reads = 0
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------


class PlanCache:
    """LRU of optimized plans, keyed ``(skeleton, optimized, stats epoch)``.

    Shared across sessions (``db.plan_cache``) so serving workers amortize
    parse+optimize per query skeleton, not per request."""

    def __init__(self, capacity: int = 512) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Tuple[Query, lp.PlanOp]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Tuple,
                     build: Callable[[], Tuple[Query, lp.PlanOp]]
                     ) -> Tuple[Query, lp.PlanOp]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            self.misses += 1
        value = build()          # plan outside the lock; racing builds are rare
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._entries), "capacity": self.capacity}


# ---------------------------------------------------------------------------
# cursor
# ---------------------------------------------------------------------------


class Cursor:
    """Lazily streams projected rows of one statement execution.

    Iterating yields row dicts; :meth:`batches` exposes the underlying
    bounded batches.  Nothing past ``LIMIT`` (or past where you stop
    consuming) is ever computed."""

    def __init__(self, ctx: ExecutionContext,
                 plan: Optional[lp.PlanOp],
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 keys: Tuple[str, ...] = (),
                 rwlock: Optional[RWLock] = None,
                 trace: Optional[Trace] = None,
                 profile: Optional[QueryProfile] = None) -> None:
        self.context = ctx
        self.batch_rows = batch_rows
        self._keys = keys
        self._rwlock = rwlock       # chunk-level writer exclusion, if any
        self._gen: Iterator[List[Dict]] = (
            execute_iter(plan, ctx, batch_rows) if plan is not None
            else iter(()))
        self._buf: "deque[Dict]" = deque()
        self._exhausted = plan is None
        self.batches_fetched = 0
        self._deadline = None   # ClusterCursor sets this (it has no ctx)
        self.trace = trace          # per-query span tree (None = not traced)
        self._profile = profile     # QueryProfile when PROFILE/profile=True
        self._profile_plan = plan
        if self._exhausted and trace is not None:
            trace.finish()

    def keys(self) -> Tuple[str, ...]:
        return self._keys

    @property
    def deadline(self):
        """The query's shared budget object (None when no deadline)."""
        if self._deadline is not None:
            return self._deadline
        return self.context.deadline if self.context is not None else None

    @property
    def degradations(self) -> List[str]:
        """Ladder steps taken to meet the deadline (empty = exact path)."""
        d = self.deadline
        return list(d.degradations) if d is not None else []

    @property
    def approximate(self) -> bool:
        """True when any returned score is an ADC approximation rather
        than an exact re-ranked value (``skip_rerank`` was taken)."""
        d = self.deadline
        return bool(d is not None and d.approximate)

    def _next_batch(self) -> Optional[List[Dict]]:
        """Pull one batch; each pull runs under the read lock so a writer
        never resizes the stores mid-chunk.  Between pulls writers may
        commit -- use read_transaction() for whole-result isolation."""
        if self.trace is None:
            return self._next_batch_inner()
        # each pull is a direct child of the root span: pulls are where the
        # query's wall time goes, so their union is the coverage gate; a
        # pull that dies (DeadlineExceeded, ...) still closes its span and
        # finishes the trace
        try:
            with self.trace.span("cursor.pull", parent=self.trace.root):
                return self._next_batch_inner()
        except BaseException:
            self.trace.finish()
            raise

    def _next_batch_inner(self) -> Optional[List[Dict]]:
        if self._rwlock is None:
            return next(self._gen, None)
        self._rwlock.acquire_read()
        try:
            return next(self._gen, None)
        finally:
            self._rwlock.release_read()

    def _pull(self) -> bool:
        while not self._buf and not self._exhausted:
            batch = self._next_batch()
            if batch is None:
                self._exhausted = True
                if self.trace is not None:
                    self.trace.finish()
                return False
            self.batches_fetched += 1
            self._buf.extend(batch)
        return bool(self._buf)

    def __iter__(self) -> "Cursor":
        return self

    def __next__(self) -> Dict:
        if not self._pull():
            raise StopIteration
        return self._buf.popleft()

    def batches(self) -> Iterator[List[Dict]]:
        """Yield the remaining rows batch-by-batch (each ≤ batch_rows * the
        per-row fanout of expands)."""
        if self._buf:
            out = list(self._buf)
            self._buf.clear()
            yield out
        while not self._exhausted:
            batch = self._next_batch()
            if batch is None:
                self._exhausted = True
                if self.trace is not None:
                    self.trace.finish()
                return
            self.batches_fetched += 1
            yield batch

    def fetchone(self) -> Optional[Dict]:
        return next(self, None)

    def fetchmany(self, n: int) -> List[Dict]:
        out: List[Dict] = []
        if n <= 0:
            return out
        for row in self:
            out.append(row)
            if len(out) >= n:
                break
        return out

    def fetchall(self) -> List[Dict]:
        return list(self)

    def close(self) -> None:
        if hasattr(self._gen, "close"):
            self._gen.close()
        self._buf.clear()
        self._exhausted = True
        if self.trace is not None:
            self.trace.finish()

    # -- PROFILE -----------------------------------------------------------------

    @property
    def profiled(self) -> bool:
        return self._profile is not None

    def profile_report(self, include_trace: bool = False) -> Optional[Dict[str, Any]]:
        """The PROFILE payload (per-operator annotated plan, φ accounting,
        cluster events, cost-model drift).  None unless the statement ran
        with ``PROFILE`` / ``profile=True``.  Consume the cursor first —
        the report covers whatever has executed so far."""
        if self._profile is None:
            return None
        if self.trace is not None and self._exhausted:
            self.trace.finish()
        return self._profile.report(self._profile_plan, trace=self.trace,
                                    deadline=self.deadline,
                                    include_trace=include_trace)


# ---------------------------------------------------------------------------
# prepared statements
# ---------------------------------------------------------------------------


class PreparedStatement:
    """A query parsed once; each :meth:`run` late-binds ``$params`` and
    executes the (cached) optimized plan."""

    def __init__(self, session: "Session", text: str) -> None:
        self.session = session
        self.text = text
        self.skeleton = skeleton_of(text)
        self.query: Query = parse_query(text)
        self.param_names = frozenset(query_params(self.query))

    def run(self, parameters: Optional[Dict[str, Any]] = None,
            optimized: bool = True,
            deadline_ms: Optional[float] = None,
            profile: bool = False, **params: Any) -> Cursor:
        return self.session._run_parsed(self.skeleton, self.query,
                                        {**(parameters or {}), **params},
                                        optimized=optimized, text=self.text,
                                        deadline_ms=deadline_ms,
                                        profile=profile)

    def explain(self) -> Dict[str, Any]:
        return self.session.explain(self.text)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PreparedStatement({self.skeleton!r}, "
                f"params={sorted(self.param_names)})")


# ---------------------------------------------------------------------------
# transactions
# ---------------------------------------------------------------------------


class Transaction:
    """Explicit transaction scope over the WAL.

    ``mode='r'``: shared lock -- concurrent readers proceed, writers wait.
    Cursors returned inside the scope are materialized before the lock is
    released, so rows never stream outside the isolation window.

    ``mode='w'``: exclusive lock; write statements of the scope are
    *deferred* -- applied to the graph and group-committed to the WAL only
    on successful exit.  An aborted scope (exception inside the block)
    therefore mutates nothing and logs nothing.  Consequence: reads inside
    a write scope see the pre-transaction state.  A failure *during commit*
    (e.g. an unreadable ``createFromSource`` path) stops mid-sequence:
    statements already applied stay applied *and* logged, so leader and WAL
    remain consistent with each other -- the commit is partial, never
    divergent."""

    def __init__(self, session: "Session", mode: str) -> None:
        assert mode in ("r", "w")
        self.session = session
        self.mode = mode
        self._deferred: List[Tuple[CreateQuery, str, Dict[str, Any]]] = []
        self._active = False

    # -- context management ----------------------------------------------------

    def __enter__(self) -> "Transaction":
        if self.session._tx is not None:
            raise RuntimeError(
                "this session already has an open transaction; nested "
                "transactions are not supported")
        lock = self.session.db.rwlock
        (lock.acquire_read if self.mode == "r" else lock.acquire_write)()
        self._active = True
        self.session._tx = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        lock = self.session.db.rwlock
        try:
            if self.mode == "w" and exc_type is None:
                for q, text, params in self._deferred:   # apply + group commit
                    self.session.db._execute_create(q, text, params=params)
            self._deferred.clear()
        finally:
            self._active = False
            self.session._tx = None
            (lock.release_read if self.mode == "r" else lock.release_write)()

    # -- statement execution within the scope -----------------------------------

    def run(self, text: str, parameters: Optional[Dict[str, Any]] = None,
            optimized: bool = True, **params: Any) -> Cursor:
        """Run inside the scope; reads come back fully materialized (the
        session materializes whenever a transaction is active)."""
        if not self._active:
            raise RuntimeError("transaction already closed")
        return self.session.run(text, parameters, optimized=optimized,
                                **params)

    def defer(self, q: CreateQuery, text: str,
              params: Dict[str, Any]) -> None:
        """Queue a write for apply + WAL group commit at scope exit.
        Renderability is validated here, not at commit, so a bad value
        fails the scope before any earlier statement could be applied."""
        if self.mode != "w":
            raise RuntimeError("read transactions cannot defer writes")
        check_wal_renderable(q, params)
        self._deferred.append((q, text, dict(params)))


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------


class Session:
    """One client's conversation with the database.

    Cheap to create; holds no graph state, only a handle to the shared plan
    cache and a default cursor batch size.  Not itself thread-safe (use one
    session per worker thread).  Writes take the db-level RWLock's exclusive
    side; cursors outside transactions take the shared side per chunk pull,
    so a concurrent writer can commit *between* chunks but never mutate the
    stores mid-chunk.  Use read_transaction() for whole-result isolation."""

    def __init__(self, db, batch_rows: int = DEFAULT_BATCH_ROWS,
                 plan_cache: Optional[PlanCache] = None,
                 use_cache: bool = True,
                 prefetch_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None) -> None:
        self.db = db
        self.batch_rows = batch_rows
        #: per-session φ prefetch window (None = AIPMConfig default); serving
        #: workers tune this per workload without touching the shared config
        self.prefetch_depth = prefetch_depth
        #: default per-query budget for every run() that names none
        #: (run(deadline_ms=) overrides; ClusterConfig.default_deadline_ms
        #: backstops both; None/0 anywhere = no deadline)
        self.deadline_ms = deadline_ms
        self.cache: Optional[PlanCache] = (
            plan_cache if plan_cache is not None
            else (db.plan_cache if use_cache else None))
        self._tx: Optional[Transaction] = None
        self._closed = False

    # -- lifecycle ---------------------------------------------------------------

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True

    # -- prepare / run -----------------------------------------------------------

    def prepare(self, text: str) -> PreparedStatement:
        return PreparedStatement(self, text)

    def run(self, text: str, parameters: Optional[Dict[str, Any]] = None,
            optimized: bool = True,
            deadline_ms: Optional[float] = None,
            profile: bool = False, trace: Optional[Trace] = None,
            **params: Any) -> Cursor:
        """Parse (cached), optimize (cached), execute; returns a streaming
        :class:`Cursor`.  CREATE statements return an empty cursor.

        Bind ``$name`` placeholders as keyword args, or -- for names that
        collide with this method's own arguments (``text``, ``optimized``,
        ``deadline_ms``) -- via the neo4j-style ``parameters`` dict; kwargs
        win on overlap.  ``deadline_ms`` is this statement's end-to-end
        budget (a number, or an already-ticking
        :class:`~repro_torch.core.deadline.Deadline`).  ``profile=True`` (or a
        ``PROFILE`` query prefix) traces + profiles this statement
        regardless of the tracer switch; read ``cursor.profile_report()``
        after consuming.  ``trace`` lets a caller that already opened a
        span tree (the serving engine) pass it down."""
        if self._closed:
            raise RuntimeError("session is closed")
        params = {**(parameters or {}), **params}
        skeleton = skeleton_of(text)
        profile = profile or skeleton[:8].upper() == "PROFILE "
        if trace is None:
            trace = self.db.tracer.begin("query", force=profile,
                                         skeleton=skeleton)
        if self.cache is None or skeleton[:6].upper() == "CREATE":
            return self._run_parsed(skeleton, parse_query(text), params,
                                    optimized=optimized, text=text,
                                    deadline_ms=deadline_ms,
                                    profile=profile, trace=trace)
        # fast path: resolve through the plan cache without parsing
        self.db.stats.refresh_from_graph(self.db.graph)
        self.db.stats.refresh_extractor_stats(self.db.registry)
        key = (skeleton, optimized, self.db.stats.epoch)
        if trace is None:
            q, plan = self.cache.get_or_build(
                key, lambda: self._parse_and_plan(text, optimized))
        else:
            with trace.span("plan") as sp:
                misses0 = self.cache.misses
                q, plan = self.cache.get_or_build(
                    key, lambda: self._parse_and_plan(text, optimized))
                sp.set(cache="miss" if self.cache.misses > misses0 else "hit")
        return self._execute(q, plan, params, text, deadline_ms=deadline_ms,
                             profile=profile, trace=trace)

    def _run_parsed(self, skeleton: str, q: Query, params: Dict[str, Any],
                    optimized: bool, text: str,
                    deadline_ms: Optional[float] = None,
                    profile: bool = False,
                    trace: Optional[Trace] = None) -> Cursor:
        """Execute an already-parsed query (run() and PreparedStatement
        both land here)."""
        if self._closed:
            raise RuntimeError("session is closed")
        profile = profile or bool(getattr(q, "profile", False))
        if trace is None:
            trace = self.db.tracer.begin("query", force=profile,
                                         skeleton=skeleton)
        if isinstance(q, CreateQuery):
            return self._execute(q, None, params, text,
                                 deadline_ms=deadline_ms,
                                 profile=profile, trace=trace)
        self.db.stats.refresh_from_graph(self.db.graph)
        self.db.stats.refresh_extractor_stats(self.db.registry)
        if self.cache is None:
            return self._execute(q, plan_query(self.db, q, optimized),
                                 params, text, deadline_ms=deadline_ms,
                                 profile=profile, trace=trace)
        key = (skeleton, optimized, self.db.stats.epoch)
        if trace is None:
            _, plan = self.cache.get_or_build(
                key, lambda: (q, plan_query(self.db, q, optimized)))
        else:
            with trace.span("plan") as sp:
                misses0 = self.cache.misses
                _, plan = self.cache.get_or_build(
                    key, lambda: (q, plan_query(self.db, q, optimized)))
                sp.set(cache="miss" if self.cache.misses > misses0 else "hit")
        return self._execute(q, plan, params, text, deadline_ms=deadline_ms,
                             profile=profile, trace=trace)

    def _parse_and_plan(self, text: str,
                        optimized: bool) -> Tuple[Query, Optional[lp.PlanOp]]:
        q = parse_query(text)
        if isinstance(q, CreateQuery):
            return q, None
        return q, plan_query(self.db, q, optimized)

    def _execute(self, q: Query, plan: Optional[lp.PlanOp],
                 params: Dict[str, Any], text: str,
                 deadline_ms: Optional[float] = None,
                 profile: bool = False,
                 trace: Optional[Trace] = None) -> Cursor:
        missing = query_params(q) - set(params)
        if missing:
            raise KeyError(f"unbound parameters: "
                           f"{', '.join('$' + m for m in sorted(missing))}")
        deadline = Deadline.resolve(
            deadline_ms, self.deadline_ms,
            self.db.cfg.cluster.default_deadline_ms)
        qprof: Optional[QueryProfile] = None
        if profile:
            qprof = QueryProfile()
            if plan is not None:
                qprof.capture_predictions(plan, self.db.stats)
        ctx = ExecutionContext(self.db, params,
                               prefetch_depth=self.prefetch_depth,
                               deadline=deadline,
                               trace=trace, profile=qprof)
        if isinstance(q, CreateQuery):
            self._execute_write(q, text, params)
            return Cursor(ctx, None, trace=trace, profile=qprof)
        assert plan is not None
        if self._tx is not None:
            # inside a transaction the scope already holds the lock; rows
            # must not stream past its release, so materialize here
            cur = Cursor(ctx, plan, self.batch_rows,
                         keys=_projection_keys(q),
                         trace=trace, profile=qprof)
            rows = cur.fetchall()
            out = Cursor(ctx, None, keys=cur.keys(),
                         trace=trace, profile=qprof)
            out._profile_plan = plan
            out._buf.extend(rows)
            return out
        # otherwise each chunk pull takes the shared lock side so writers
        # never race a mid-chunk scan
        return Cursor(ctx, plan, self.batch_rows, keys=_projection_keys(q),
                      rwlock=self.db.rwlock, trace=trace, profile=qprof)

    def _execute_write(self, q: CreateQuery, text: str,
                       params: Dict[str, Any]) -> None:
        tx = self._tx
        if tx is not None and tx.mode == "w":
            tx.defer(q, text, params)
            return
        if tx is not None:
            raise RuntimeError("write statement inside a read transaction")
        self.db.rwlock.acquire_write()
        try:
            self.db._execute_create(q, text, params=params)
        finally:
            self.db.rwlock.release_write()

    # -- transactions ------------------------------------------------------------

    def read_transaction(self) -> Transaction:
        return Transaction(self, "r")

    def write_transaction(self) -> Transaction:
        return Transaction(self, "w")

    # -- introspection -----------------------------------------------------------

    def explain(self, text: str) -> Dict[str, Any]:
        """Optimized vs naive plan + costs, plus plan-cache counters."""
        out = self.db.explain(text)
        if self.cache is not None:
            out["plan_cache"] = self.cache.stats()
        return out


# ---------------------------------------------------------------------------
# planning helpers
# ---------------------------------------------------------------------------


def plan_query(db, q: MatchQuery, optimized: bool) -> lp.PlanOp:
    """AST -> (optimized) physical plan; stats must already be fresh."""
    if not isinstance(q, MatchQuery):
        raise TypeError("can only plan MATCH queries")
    qg = QueryGraph.from_query(q)
    acc = getattr(q, "accuracy", None)
    plan = (optimize(qg, db.stats, acc) if optimized
            else naive_plan(qg, db.stats, acc))
    plan = lp.Projection(plan, q.returns)
    if q.limit is not None:
        plan = lp.Limit(plan, q.limit)
    return plan


def _projection_keys(q: Query) -> Tuple[str, ...]:
    if not isinstance(q, MatchQuery):
        return ()
    from repro_torch.core.executor import _name_of
    return tuple(item.alias or _name_of(item.expr) for item in q.returns)
