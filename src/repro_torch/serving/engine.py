"""Query serving engine: concurrent CypherPlus requests against PandaDB.

Reproduces the paper's Fig 8 setup: a request queue, worker(s) executing
queries, measured throughput + response-time percentiles.  Each worker owns
a driver :class:`~repro_torch.core.session.Session`; prepared statements are
reused per query skeleton (the shared plan cache means parse+optimize run
once per skeleton across the whole server, not once per request).
Reading-queries go to any worker; writing-queries serialize through the
db-level write lock + leader WAL (paper §VII-A).

``db`` may be a single-node :class:`~repro_torch.core.database.PandaDB` or
a :class:`~repro_torch.cluster.ShardedPandaDB` coordinator -- the session
surfaces are interchangeable, so every worker's statements route through
the coordinator (scatter-gather fan-out or owner-shard routing per
statement) while the cluster-wide plan cache keeps parse+optimize amortized
exactly as on one node.  The server runs on the db's (or coordinator's)
device, the CUDA card unless it was built with ``device="cpu"``.
:meth:`QueryServer.route_counts` surfaces the coordinator's routing
decisions and failure-masking counters for the load just served.

**Overload behavior** (``ServingConfig``): the request queue can be bounded
(``queue_depth``), with admission policy ``"reject"`` (the submitter gets
:class:`~repro_torch.core.deadline.OverloadedError` with a retry-after hint) or
``"drop_oldest"`` (the stalest queued request is failed with
``OverloadedError`` to make room -- freshest-first under overload).
Requests carry an end-to-end :class:`~repro_torch.core.deadline.Deadline` from
the moment of *admission*, so queue time burns the same budget execution
does.  With ``shed_on_arrival`` the engine compares its per-skeleton
service-time EWMA (plus expected queue wait) against the request's
remaining budget and sheds doomed work at the door instead of timing it
out after it consumed a worker.  Workers drop requests whose budget
expired while queued (``expired``) without executing them.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.configs.pandadb import ServingConfig
from repro_torch.core.deadline import Deadline, DeadlineExceeded, OverloadedError
from repro_torch.obs import MetricsRegistry, SlowQueryLog

#: a request: query text, or (text, params dict)
Request = Union[str, Tuple[str, Dict[str, Any]]]


@dataclasses.dataclass
class ServeStats:
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    #: time each executed request spent queued before a worker picked it up
    queue_ms: List[float] = dataclasses.field(default_factory=list)
    #: client-observed latency (admission -> completion) per finished request
    e2e_ms: List[float] = dataclasses.field(default_factory=list)
    started: float = 0.0
    finished: float = 0.0

    @property
    def throughput_qps(self) -> float:
        dur = max(self.finished - self.started, 1e-9)
        return len(self.latencies_ms) / dur

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(self.latencies_ms, p))

    def summary(self) -> Dict[str, float]:
        out = {
            "requests": len(self.latencies_ms),
            "throughput_qps": self.throughput_qps,
            "mean_ms": float(np.mean(self.latencies_ms)) if self.latencies_ms else 0,
            "p50_ms": self.percentile(50),
            "p99_ms": self.percentile(99),
        }
        if self.queue_ms:
            out["mean_queue_ms"] = float(np.mean(self.queue_ms))
        return out


class _ServeRequest:
    __slots__ = ("text", "params", "optimized", "done", "deadline",
                 "t_submit", "trace")

    def __init__(self, text: str, params: Dict[str, Any], optimized: bool,
                 done: Callable[[Tuple[Any, Any]], None],
                 deadline: Optional[Deadline], t_submit: float,
                 trace=None) -> None:
        self.text = text
        self.params = params
        self.optimized = optimized
        self.done = done
        self.deadline = deadline
        self.t_submit = t_submit
        self.trace = trace      # span tree opened at admission (or None)


class _AdmissionQueue:
    """Bounded FIFO with admission policies, built on a condition variable
    so workers block (no polling) and wake exactly when work or a shutdown
    sentinel arrives.

    ``depth == 0`` means unbounded (the seed's behavior).  Sentinels
    (``None``) bypass the bound: shutdown must always get through."""

    def __init__(self, depth: int = 0) -> None:
        self.depth = int(depth)
        self._q: deque = deque()
        self._cv = threading.Condition()

    def __len__(self) -> int:
        with self._cv:
            return sum(1 for item in self._q if item is not None)

    def put(self, item: _ServeRequest,
            policy: str = "reject") -> Tuple[bool, List[_ServeRequest]]:
        """Try to admit ``item``.  Returns ``(admitted, dropped)`` where
        ``dropped`` holds requests evicted under ``drop_oldest``."""
        with self._cv:
            dropped: List[_ServeRequest] = []
            if 0 < self.depth <= sum(
                    1 for it in self._q if it is not None):
                if policy != "drop_oldest":
                    return False, []
                for i, old in enumerate(self._q):
                    if old is not None:
                        del self._q[i]
                        dropped.append(old)
                        break
                else:           # only sentinels queued; nothing to evict
                    return False, []
            self._q.append(item)
            self._cv.notify()
            return True, dropped

    def put_sentinel(self) -> None:
        with self._cv:
            self._q.append(None)
            self._cv.notify()

    def get(self) -> Optional[_ServeRequest]:
        with self._cv:
            while not self._q:
                self._cv.wait()
            return self._q.popleft()


class QueryServer:
    def __init__(self, db, n_workers: int = 1,
                 use_prepared: bool = True,
                 prefetch_depth: Optional[int] = None,
                 serving: Optional[ServingConfig] = None) -> None:
        #: the device requests run on: the db's own
        self.device = db.device
        self.db = db
        self.n_workers = n_workers
        self.use_prepared = use_prepared
        #: per-worker φ prefetch window (None = AIPMConfig default, 0 = sync)
        self.prefetch_depth = prefetch_depth
        if serving is None:
            serving = getattr(getattr(db, "cfg", None), "serving", None) \
                or ServingConfig()
        self.serving = serving
        self._queue = _AdmissionQueue(depth=serving.queue_depth)
        self._stats = ServeStats()
        self._lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self._started = False
        self._closed = False
        #: unified registry: admission/overload counters + latency
        #: histograms; ``overload_counters()`` is the byte-compatible view
        self.metrics = MetricsRegistry("serve")
        for name in ("submitted", "completed", "in_budget", "failed",
                     "shed", "rejected", "dropped", "expired", "degraded"):
            self.metrics.counter(name)
        #: the db's tracer (PandaDB and the coordinators both carry one);
        #: None on bare objects without the obs wiring
        self.tracer = getattr(db, "tracer", None)
        ocfg = getattr(getattr(db, "cfg", None), "obs", None)
        self.slow_log: Optional[SlowQueryLog] = None
        if ocfg is not None and ocfg.slow_query_log \
                and ocfg.slow_query_ms > 0:
            self.slow_log = SlowQueryLog(ocfg.slow_query_log,
                                         ocfg.slow_query_ms)
        #: per-skeleton service-time EWMA (seconds), the admission-control
        #: cost model: cheap, self-tuning, keyed by query text
        self._service_ewma: Dict[str, float] = {}

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._stats.started = time.perf_counter()
        for _ in range(self.n_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._workers.append(t)

    def close(self) -> None:
        """Idempotent: drains queued work (workers exit on their sentinel,
        which sits behind everything already admitted), joins workers."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._workers:
            self._queue.put_sentinel()
        for t in self._workers:
            t.join(timeout=10.0)
        self._workers = []

    def shutdown(self) -> None:
        self.close()

    # -- admission control -----------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        self.metrics.counter(name).inc(n)

    def _note_service(self, text: str, dt_s: float) -> None:
        with self._lock:
            old = self._service_ewma.get(text)
            self._service_ewma[text] = \
                dt_s if old is None else 0.2 * dt_s + 0.8 * old

    def _estimate_service_s(self, text: str) -> Optional[float]:
        with self._lock:
            est = self._service_ewma.get(text)
            if est is None and self._service_ewma:
                est = float(np.mean(list(self._service_ewma.values())))
            return est

    def _retry_after_s(self, est: Optional[float]) -> float:
        per = est if est is not None else 0.001
        return max(0.001, len(self._queue) * per / max(1, self.n_workers))

    def submit(self, text: str, optimized: bool = True,
               params: Optional[Dict[str, Any]] = None,
               deadline_ms: Optional[float] = None) -> "queue.Queue":
        """Admit one request.  Raises :class:`OverloadedError` when the
        queue is full under the ``reject`` policy, or when shed-on-arrival
        predicts the request cannot finish inside its budget.  Otherwise
        returns a size-1 queue that will receive ``(rows, error)``."""
        scfg = self.serving
        deadline = Deadline.resolve(deadline_ms, scfg.default_deadline_ms)
        self._count("submitted")
        trace = (self.tracer.begin("serve", text=text)
                 if self.tracer is not None and self.tracer.enabled else None)
        est = self._estimate_service_s(text)
        if deadline is not None and scfg.shed_on_arrival and est is not None:
            wait_est = len(self._queue) * est / max(1, self.n_workers)
            if est + wait_est > deadline.remaining():
                self._count("shed")
                if trace is not None:
                    trace.event("shed", est_ms=round(1000 * (est + wait_est),
                                                     3))
                    trace.finish()
                raise OverloadedError(
                    f"shed on arrival: estimated {1000 * (est + wait_est):.1f}ms "
                    f"service exceeds {1000 * deadline.remaining():.1f}ms budget",
                    retry_after_s=self._retry_after_s(est))
        out: "queue.Queue" = queue.Queue(maxsize=1)
        req = _ServeRequest(text, params or {}, optimized, out.put, deadline,
                            time.perf_counter(), trace=trace)
        admitted, dropped = self._queue.put(req, policy=scfg.admission_policy)
        for old in dropped:
            self._count("dropped")
            if old.trace is not None:
                old.trace.event("drop")
                old.trace.finish()
            old.done(([], OverloadedError(
                "dropped from queue to admit fresher work",
                retry_after_s=self._retry_after_s(est))))
        if not admitted:
            self._count("rejected")
            if trace is not None:
                trace.event("drop", reason="queue_full")
                trace.finish()
            raise OverloadedError(
                f"queue full ({self._queue.depth} deep)",
                retry_after_s=self._retry_after_s(est))
        return out

    # -- execution -------------------------------------------------------------

    def _worker(self) -> None:
        # one session per worker.  Statement reuse needs no worker-local
        # cache: session.run() resolves parse+optimize through the db-level
        # PlanCache by query skeleton, so any worker's prepared skeleton
        # serves every worker (use_prepared=False disables the cache to
        # reproduce the seed's parse-per-request behavior).
        session = self.db.session(use_cache=self.use_prepared,
                                  prefetch_depth=self.prefetch_depth)
        while True:
            req = self._queue.get()
            if req is None:
                return
            self._execute(session, req)

    def _execute(self, session, req: _ServeRequest) -> None:
        t0 = time.perf_counter()
        qms = (t0 - req.t_submit) * 1000
        trace = req.trace
        if trace is not None:
            # the queue wait, after the fact: admission -> worker pickup
            trace.add_timed("queue.wait", qms / 1000, parent=trace.root)
        d = req.deadline
        if d is not None and d.expired():
            # budget burned in the queue; do not occupy the worker
            self._count("expired")
            if trace is not None:
                trace.event("degradation", step="expired_in_queue")
                trace.finish()
            req.done(([], DeadlineExceeded(
                "queued", d.budget_s * 1000, d.elapsed() * 1000)))
            return
        degradations: List[str] = []
        try:
            cur = session.run(req.text, req.params, optimized=req.optimized,
                              deadline_ms=d, trace=trace)
            rows = cur.fetchall()
            degradations = cur.degradations
            err: Optional[BaseException] = None
        except DeadlineExceeded as e:
            rows, err = [], e
            self._count("expired")
        except Exception as e:  # noqa: BLE001 -- surfaced to the caller
            rows, err = [], e
            self._count("failed")
        dt = time.perf_counter() - t0
        if trace is not None:
            trace.finish()
        if err is None:
            self._count("completed")
            if degradations:
                self._count("degraded")
            if d is None or not d.expired():
                self._count("in_budget")
            self._note_service(req.text, dt)
        self.metrics.histogram("latency_ms").observe(dt * 1000)
        self.metrics.histogram("queue_ms").observe(qms)
        self.metrics.histogram("e2e_ms").observe(qms + dt * 1000)
        if self.slow_log is not None:
            self.slow_log.maybe_log(
                text=req.text, total_ms=qms + dt * 1000, queue_ms=qms,
                rows=len(rows), error=type(err).__name__ if err else None,
                degradations=degradations,
                trace_id=trace.trace_id if trace is not None else None)
        with self._lock:
            self._stats.latencies_ms.append(dt * 1000)
            self._stats.queue_ms.append(qms)
            self._stats.e2e_ms.append(qms + dt * 1000)
        req.done((rows, err))

    # -- load drivers ----------------------------------------------------------

    def run_closed_loop(self, queries: List[Request], n_clients: int,
                        duration_s: float = 2.0,
                        optimized: bool = True) -> ServeStats:
        """Closed-loop load: each client resubmits on completion (the JMeter
        pattern from §VII-D)."""
        self.start()
        stop_at = time.perf_counter() + duration_s

        def client(cid: int):
            i = 0
            while time.perf_counter() < stop_at:
                q = queries[(cid + i) % len(queries)]
                text, params = q if isinstance(q, tuple) else (q, None)
                try:
                    self.submit(text, optimized, params).get()
                except OverloadedError as e:
                    # closed-loop under a bounded queue: honor the hint
                    time.sleep(min(e.retry_after_s, 0.05))
                i += 1

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._stats.finished = time.perf_counter()
        self.shutdown()
        return self._stats

    def run_open_loop(self, queries: List[Request], rate_qps: float,
                      duration_s: float = 2.0, optimized: bool = True,
                      deadline_ms: Optional[float] = None) -> Dict[str, float]:
        """Open-loop (offered-load) driver: submit at a fixed rate whether
        or not earlier requests finished -- the regime where overload
        actually happens (closed-loop load self-throttles).  Returns a
        summary with goodput (completions *within budget* per second) and
        client-observed percentiles over completed requests."""
        self.start()
        rate_qps = float(rate_qps)
        interval = 1.0 / max(rate_qps, 1e-9)
        n = max(1, int(round(rate_qps * duration_s)))
        outs: List["queue.Queue"] = []
        t0 = time.perf_counter()
        for i in range(n):
            delay = (t0 + i * interval) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            q = queries[i % len(queries)]
            text, params = q if isinstance(q, tuple) else (q, None)
            try:
                outs.append(self.submit(text, optimized, params,
                                        deadline_ms=deadline_ms))
            except OverloadedError:
                continue        # counted by submit(); client walks away
        drain_to = 10.0 + 2 * (deadline_ms or 0) / 1000
        for out in outs:
            try:
                out.get(timeout=drain_to)
            except queue.Empty:     # pragma: no cover - hung worker guard
                break
        elapsed = time.perf_counter() - t0
        self._stats.finished = time.perf_counter()
        counters = self.overload_counters()
        with self._lock:
            e2e = list(self._stats.e2e_ms)
        good = counters["in_budget"]
        return {
            "offered_qps": rate_qps,
            "duration_s": elapsed,
            "goodput_qps": good / max(elapsed, 1e-9),
            "p50_ms": float(np.percentile(e2e, 50)) if e2e else 0.0,
            "p99_ms": float(np.percentile(e2e, 99)) if e2e else 0.0,
            **{k: float(v) for k, v in counters.items()},
        }

    # -- introspection ---------------------------------------------------------

    def overload_counters(self) -> Dict[str, int]:
        """Admission-control + deadline counters for the load just served:
        ``shed`` (refused at the door), ``rejected`` (queue full),
        ``dropped`` (evicted under drop_oldest), ``expired`` (budget gone
        before/while executing), ``degraded`` (completed via the ladder),
        ``in_budget`` (completed inside their budget)."""
        return self.metrics.counters_view()

    def route_counts(self) -> Dict[str, int]:
        """Routed-vs-fanout statement counts when serving a sharded
        coordinator ({} on a single-node db), merged with the cluster's
        failure-masking counters (hedges fired/won, retries, failovers,
        rebalance moves, per-node replica reads) when available, plus this
        server's admission/overload counters under ``serve_*`` keys."""
        out = dict(getattr(self.db, "route_counts", {}))
        counters = getattr(self.db, "cluster_counters", None)
        if callable(counters):
            out.update(counters())
        for k, v in self.overload_counters().items():
            out[f"serve_{k}"] = v
        return out
