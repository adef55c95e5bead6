"""Self-healing replicated cluster (paper §VII-A high availability).

The paper's cluster keeps R copies of every shard behind the leader's
versioned WAL; here each shard becomes a :class:`ReplicaSet` of R full
:class:`~repro_torch.core.database.PandaDB` nodes:

* **writes** go through the replica set's op log (the leader-WAL path):
  every coordinator write is a named ``(op, args, kwargs)`` tuple recorded
  with an ascending version and applied to every live replica, so a revived
  replica replays exactly the ops it missed (:meth:`ReplicaSet.revive` ==
  the paper's version catch-up for a rejoining node).
* **reads** pick a replica by observed per-replica latency EWMA
  (``StatisticsService.choose_replica``) and are failure-masked three ways:
  retry-with-backoff on transient errors, failover to a sibling replica on
  fail-stop (streams fast-forward past already-merged anchor ids, so the
  merged output is byte-identical to a healthy run), and **hedged reads** --
  if the preferred replica has not answered within a latency-quantile
  deadline (``stats.hedge_deadline``), a second replica races it and the
  first responder wins; the loser is cancelled through the φ-cancelling
  iterator close.

Fault injection (:class:`FaultInjector`: fail-stop, slow-node, error-on-
call, all driven by a seeded RNG) is part of the subsystem so chaos tests
and the failover benchmark exercise exactly the production code paths.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import (CancelledError, FIRST_COMPLETED,
                                ThreadPoolExecutor, wait)
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.configs.pandadb import PandaDBConfig
from repro_torch.core.database import PandaDB
from repro_torch.core.deadline import Deadline
from repro_torch.core.executor import ExecutionContext, execute_iter_tagged
from repro_torch.core.vector_index import scatter_gather_knn
from repro_torch.cluster.coordinator import ShardedPandaDB, _apply_op
from repro_torch.cluster.partition import make_shard
from repro_torch.device import DeviceLike
from repro_torch.graphstore.wal import WriteAheadLog


class ReplicaDown(RuntimeError):
    """The replica is fail-stopped (or a whole shard has no live replica)."""


class ReplicaError(RuntimeError):
    """A transient per-call fault -- retryable on the same replica."""


class FaultInjector:
    """Deterministic fault injection, consulted on every replica access.

    All randomness (probabilistic slow-downs) comes from one seeded
    generator, so chaos tests and the failover benchmark are exactly
    reproducible run-to-run."""

    def __init__(self, seed: int = 0) -> None:
        self.rng = np.random.default_rng(seed)
        self._down: Set[Tuple[int, int]] = set()
        self._slow: Dict[Tuple[int, int], Tuple[float, float]] = {}
        self._errors: Dict[Tuple[int, int], int] = {}
        self.injected: Dict[str, int] = {"fail_stops": 0, "slow_sleeps": 0,
                                         "errors": 0}
        self._lock = threading.Lock()

    def fail_stop(self, shard: int, replica: int) -> None:
        """Kill (shard, replica): every subsequent access raises
        :class:`ReplicaDown` until :meth:`heal`."""
        with self._lock:
            self._down.add((shard, replica))
            self.injected["fail_stops"] += 1

    def slow(self, shard: int, replica: int, delay_s: float,
             prob: float = 1.0) -> None:
        """Each access sleeps ``delay_s`` with probability ``prob``."""
        with self._lock:
            self._slow[(shard, replica)] = (float(delay_s), float(prob))

    def error_on_call(self, shard: int, replica: int, times: int = 1) -> None:
        """The next ``times`` accesses raise :class:`ReplicaError`."""
        with self._lock:
            self._errors[(shard, replica)] = \
                self._errors.get((shard, replica), 0) + int(times)

    def heal(self, shard: int, replica: int) -> None:
        with self._lock:
            self._down.discard((shard, replica))
            self._slow.pop((shard, replica), None)
            self._errors.pop((shard, replica), None)

    def is_down(self, shard: int, replica: int) -> bool:
        with self._lock:
            return (shard, replica) in self._down

    def check(self, shard: int, replica: int) -> None:
        """Read-path gate: raise / delay according to the injected faults
        (the sleep happens outside the lock so slow replicas do not stall
        fault bookkeeping for the healthy ones)."""
        key = (shard, replica)
        delay = 0.0
        with self._lock:
            if key in self._down:
                raise ReplicaDown(f"shard {shard} replica {replica} is down")
            n = self._errors.get(key, 0)
            if n > 0:
                self._errors[key] = n - 1
                self.injected["errors"] += 1
                raise ReplicaError(
                    f"injected transient error on shard {shard} "
                    f"replica {replica}")
            sl = self._slow.get(key)
            if sl is not None:
                d, p = sl
                if p >= 1.0 or float(self.rng.random()) < p:
                    delay = d
                    self.injected["slow_sleeps"] += 1
        if delay > 0.0:
            time.sleep(delay)


class CircuitBreaker:
    """Per-replica failure gate: closed -> open -> half-open -> closed.

    ``record_failure`` counts *consecutive* failures (a success resets);
    hitting the threshold -- or any failure while half-open -- trips the
    breaker OPEN for ``reset_s``, during which :meth:`allow` refuses the
    replica so retries stop hammering a node that keeps failing.  After the
    cool-down exactly ONE caller is admitted as the half-open probe; its
    success closes the breaker, its failure re-opens it.  Slow calls
    (latency above ``slow_call_s``, when enabled) count as failures, so a
    consistently lagging replica is quarantined like a flapping one.

    ``opens``/``probes``/``closes`` are cumulative transition counters --
    the chaos suite asserts recovery shapes on these instead of timing."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures: int = 2, reset_s: float = 0.25,
                 slow_call_s: float = 0.0) -> None:
        self.failure_threshold = max(1, int(failures))
        self.reset_s = float(reset_s)
        self.slow_call_s = float(slow_call_s)
        self.state = self.CLOSED
        self.opens = 0
        self.probes = 0
        self.closes = 0
        self._consecutive = 0
        self._probing = False
        self._probe_at = 0.0
        self._open_until = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """May this replica serve a read right now?  Transitions OPEN ->
        HALF_OPEN once the cool-down has passed; in HALF_OPEN admits only
        one probe at a time (an admitted-but-unresolved probe expires after
        ``reset_s``, so a probe the replica picker never actually routed to
        cannot wedge the breaker half-open forever)."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            now = time.perf_counter()
            if self.state == self.OPEN:
                if now < self._open_until:
                    return False
                self.state = self.HALF_OPEN
                self._probing = False
            if self._probing and now - self._probe_at <= self.reset_s:
                return False
            self._probing = True
            self._probe_at = now
            self.probes += 1
            return True

    def record_success(self, latency_s: float = 0.0) -> None:
        with self._lock:
            if 0.0 < self.slow_call_s < latency_s:
                self._failure_locked()
                return
            if self.state != self.CLOSED:
                self.closes += 1
            self.state = self.CLOSED
            self._consecutive = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failure_locked()

    def trip(self) -> None:
        """Immediate open (an observed fail-stop needs no vote count)."""
        with self._lock:
            self._trip_locked()

    def reset_half_open(self) -> None:
        """Post-``revive()``: skip the cool-down so the next read is the
        probe that can bring the replica back into rotation."""
        with self._lock:
            if self.state != self.CLOSED:
                self.state = self.HALF_OPEN
                self._probing = False

    def _failure_locked(self) -> None:
        self._consecutive += 1
        if (self.state == self.HALF_OPEN
                or self._consecutive >= self.failure_threshold):
            self._trip_locked()

    def _trip_locked(self) -> None:
        if self.state != self.OPEN:
            self.opens += 1
        self.state = self.OPEN
        self._probing = False
        self._consecutive = max(self._consecutive, self.failure_threshold)
        self._open_until = time.perf_counter() + self.reset_s


class ReplicaSet:
    """R copies of one shard behind a versioned op log (§VII-A).

    Writes append to the log first, then apply to every live replica;
    ``versions[r]`` tracks how far replica ``r`` has replayed, so
    :meth:`revive` is exactly the paper's catch-up: replay every logged op
    past the local version, then rejoin."""

    def __init__(self, shard_id: int, replicas: List[PandaDB],
                 faults: FaultInjector,
                 on_dead: Optional[Callable[[int, int], None]] = None,
                 breaker_failures: int = 2, breaker_reset_s: float = 0.25,
                 breaker_slow_call_s: float = 0.0) -> None:
        self.shard_id = shard_id
        self.replicas = replicas
        self.faults = faults
        self.alive = [True] * len(replicas)
        self.versions = [0] * len(replicas)
        self.oplog = WriteAheadLog(None)
        self.breakers = [CircuitBreaker(breaker_failures, breaker_reset_s,
                                        breaker_slow_call_s)
                         for _ in replicas]
        #: notified once per alive->dead transition the set itself observes
        #: (the coordinator counts these as failovers)
        self.on_dead = on_dead

    def _fold_down(self, r: int) -> None:
        self.alive[r] = False
        self.breakers[r].trip()
        if self.on_dead is not None:
            self.on_dead(self.shard_id, r)

    def note_success(self, r: int, latency_s: float = 0.0) -> None:
        self.breakers[r].record_success(latency_s)

    def note_failure(self, r: int) -> None:
        self.breakers[r].record_failure()

    def selectable(self) -> List[int]:
        """Live replicas whose breaker admits a call right now.  When every
        live breaker refuses (all open inside their cool-down) fall back to
        plain :meth:`live` -- serving from a suspect replica beats serving
        nothing."""
        live = self.live()
        out = [r for r in live if self.breakers[r].allow()]
        return out or live

    def live(self) -> List[int]:
        """Live replica indices; folds fail-stops observed since the last
        call into ``alive``.  Raises :class:`ReplicaDown` when the whole
        set is gone (recovery is then the rebalancer's job)."""
        out: List[int] = []
        for r in range(len(self.replicas)):
            if self.alive[r] and self.faults.is_down(self.shard_id, r):
                self._fold_down(r)
            if self.alive[r]:
                out.append(r)
        if not out:
            raise ReplicaDown(f"shard {self.shard_id}: no live replicas")
        return out

    def mark_dead(self, r: int) -> None:
        if self.alive[r]:
            self._fold_down(r)

    def apply(self, op: str, args: tuple, kw: Dict[str, Any]) -> Any:
        """Log the op, then apply it to every live replica (write path:
        only fail-stop is consulted -- a slow replica still applies every
        write, so replicas never diverge)."""
        ver = self.oplog.append((op, args, kw))
        result: Any = None
        applied = False
        for r, db in enumerate(self.replicas):
            if not self.alive[r]:
                continue
            if self.faults.is_down(self.shard_id, r):
                self._fold_down(r)
                continue
            result = _apply_op(db, op, args, kw)
            self.versions[r] = ver
            applied = True
        if not applied:
            raise ReplicaDown(
                f"shard {self.shard_id}: write {op!r} found no live replica")
        return result

    def revive(self, r: int) -> int:
        """Heal the fault, replay the missed ops in log order, rejoin.
        Returns the number of ops replayed."""
        self.faults.heal(self.shard_id, r)
        db = self.replicas[r]
        before = self.versions[r]
        self.versions[r] = self.oplog.catch_up(
            before, lambda e: _apply_op(db, e[0], e[1], e[2]))
        self.alive[r] = True
        # skip the breaker cool-down: the next read against this replica is
        # the half-open probe that can fold it back into rotation
        self.breakers[r].reset_half_open()
        return self.versions[r] - before


# -- hedged + failover read machinery -----------------------------------------

_DONE = object()

#: what a loser's φ-cancelling close is ALLOWED to raise: the stream resuming
#: into an injected fault (ReplicaDown/ReplicaError), generator shutdown
#: protocol noise (GeneratorExit escaping a nested close, RuntimeError from
#: "generator ignored GeneratorExit" / "already executing").  Anything else
#: is a real teardown bug -- counted, not swallowed silently.
_EXPECTED_TEARDOWN = (ReplicaDown, ReplicaError, GeneratorExit, RuntimeError,
                      ValueError)


def _close_quiet(it: Any, cdb: Optional["ReplicatedPandaDB"] = None) -> None:
    close = getattr(it, "close", None)
    if close is None:
        return
    try:
        close()
    except _EXPECTED_TEARDOWN:
        pass                        # loser teardown is best-effort
    except Exception:  # noqa: BLE001 -- surfaced via cluster counters
        if cdb is None:
            raise
        cdb._count("teardown_errors")


def _loser_reaper(cdb: "ReplicatedPandaDB", shard: int, r: int,
                  on_loser: Optional[Callable[[Any], None]],
                  trace=None):
    def reap(fu) -> None:
        try:
            exc = fu.exception()
        except CancelledError:
            return                  # close() cancelled it before it ran
        # reapers run as done-callbacks, possibly after the query's trace
        # closed -- a late event must not break the trace's nesting
        if trace is not None and not trace.root.closed:
            trace.event("hedge.loser_reap", parent=trace.root,
                        shard=shard, replica=r,
                        error=type(exc).__name__ if exc is not None else None)
        if exc is not None:
            if isinstance(exc, ReplicaDown):
                cdb.replica_sets[shard].mark_dead(r)
            elif not isinstance(exc, ReplicaError):
                # a loser failing with anything but an injected fault is a
                # teardown bug; fold it into the chaos-test counters
                cdb._count("teardown_errors")
            return
        if on_loser is None:
            return
        try:
            on_loser(fu.result())
        except _EXPECTED_TEARDOWN:
            pass
        except Exception:  # noqa: BLE001 -- done-callbacks must not raise
            cdb._count("teardown_errors")
    return reap


def hedged_call(cdb: "ReplicatedPandaDB", shard: int, live: List[int],
                call: Callable[[int], Any],
                on_loser: Optional[Callable[[Any], None]] = None,
                deadline: Optional[Deadline] = None,
                trace=None) -> Tuple[Any, int]:
    """Run ``call(replica)`` on the latency-preferred replica; if it has
    not answered within the shard's hedge deadline, race the next-best
    replica and take the first *success* (ties in the same wait batch
    prefer the primary, so an un-faulted cluster behaves exactly
    un-hedged).  Returns ``(result, winning replica)``.

    With a ``deadline``, every wait is clamped to the remaining budget and
    an expired budget abandons the race (legs are reaped, never orphaned)
    instead of blocking on a replica that will not answer in time.  Each
    leg's failure is charged to that replica's circuit breaker.

    Losers are not abandoned: a done-callback closes their result through
    ``on_loser`` (for streams: the φ-cancelling iterator close) and folds a
    late :class:`ReplicaDown` into the replica set."""
    rs = cdb.replica_sets[shard]
    primary = cdb.stats.choose_replica(shard, live)
    if trace is not None:
        trace.event("replica.pick", shard=shard, replica=primary,
                    breakers=",".join(b.state for b in rs.breakers))
    pool = cdb._hedge_pool
    if pool is None or len(live) < 2:
        try:
            out = call(primary)
        except (ReplicaDown, ReplicaError):
            rs.note_failure(primary)
            raise
        return out, primary
    futs = {cdb._track_hedge(pool.submit(call, primary)): primary}
    hedge_to = cdb.stats.hedge_deadline(shard)
    if deadline is not None:
        hedge_to = deadline.clamp(hedge_to)
    done, _ = wait(list(futs), timeout=hedge_to)
    if not done:
        backup = min(
            (r for r in live if r != primary),
            key=lambda r: (cdb.stats.replica_read_latency(shard, r), r))
        cdb._count("hedges_fired")
        if trace is not None:
            trace.event("hedge.fire", shard=shard, primary=primary,
                        backup=backup)
        futs[cdb._track_hedge(pool.submit(call, backup))] = backup
    winner = None
    last_exc: Optional[BaseException] = None
    pending = set(futs)
    while pending and winner is None:
        if deadline is None:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
        else:
            done, pending = wait(pending, return_when=FIRST_COMPLETED,
                                 timeout=max(0.0, deadline.remaining()))
            if not done and deadline.expired():
                # budget gone: reap every leg still racing and fail fast
                for fu, r in futs.items():
                    fu.add_done_callback(
                        _loser_reaper(cdb, shard, r, on_loser, trace=trace))
                deadline.check("hedged read")
        for fu in sorted(done, key=lambda f: futs[f] != primary):
            exc = fu.exception()
            if exc is None:
                winner = fu
                break
            last_exc = exc
            if isinstance(exc, (ReplicaDown, ReplicaError)):
                rs.note_failure(futs[fu])
            if isinstance(exc, ReplicaDown):
                rs.mark_dead(futs[fu])
    if winner is None:
        assert last_exc is not None
        raise last_exc
    if futs[winner] != primary:
        cdb._count("hedges_won")
        if trace is not None:
            trace.event("hedge.win", shard=shard, replica=futs[winner])
    for fu, r in futs.items():
        if fu is not winner:
            fu.add_done_callback(_loser_reaper(cdb, shard, r, on_loser,
                                               trace=trace))
    return winner.result(), futs[winner]


def _pull_first(cdb: "ReplicatedPandaDB", shard: int, r: int,
                open_on: Callable[[int], Any]) -> Tuple[Any, Any, float]:
    """Open replica ``r``'s stream and pull its first batch (streams are
    lazy, so hedging must cover the first real pull, not just iterator
    construction).  Returns (iterator, first batch or _DONE, seconds)."""
    t0 = time.perf_counter()
    cdb.faults.check(shard, r)
    it = open_on(r)
    try:
        first = next(it, _DONE)
    except BaseException:
        _close_quiet(it, cdb)
        raise
    return it, first, time.perf_counter() - t0


def _open_stream(cdb: "ReplicatedPandaDB", shard: int,
                 open_on: Callable[[int], Any],
                 deadline: Optional[Deadline] = None,
                 trace=None) -> Tuple[Any, Any, int]:
    """Open a stream on *some* live replica: hedged first pull, transient
    errors retried with linear backoff (clamped to any remaining deadline
    budget), fail-stops failed over until the replica set itself is
    exhausted.  Candidate replicas are breaker-filtered, so a replica that
    just burned its failure budget is skipped instead of re-tried."""
    rs = cdb.replica_sets[shard]
    attempts = 0
    while True:
        if deadline is not None:
            deadline.check("stream open")
        live = rs.selectable()
        try:
            (it, first, dt), r = hedged_call(
                cdb, shard, live,
                lambda rr: _pull_first(cdb, shard, rr, open_on),
                on_loser=lambda res: _close_quiet(res[0], cdb),
                deadline=deadline, trace=trace)
        except ReplicaDown:
            continue        # rs.live() shrinks; raises once the set is gone
        except ReplicaError:
            attempts += 1
            cdb._count("retries")
            if trace is not None:
                trace.event("retry", shard=shard, attempt=attempts,
                            where="stream_open")
            if attempts > cdb.cfg.cluster.read_retries:
                raise
            backoff = cdb.cfg.cluster.retry_backoff_s * attempts
            if deadline is not None:
                deadline.check("stream open retry")
                backoff = deadline.clamp(backoff)
            time.sleep(backoff)
            continue
        rs.note_success(r, dt)
        cdb.stats.record_replica_read(shard, r, dt)
        cdb._count_replica_read(shard, r)
        return it, first, r


def resilient_stream(cdb: "ReplicatedPandaDB", shard: int,
                     open_on: Callable[[int], Any],
                     deadline: Optional[Deadline] = None,
                     trace=None):
    """A tagged per-shard stream that survives replica failure mid-pull.

    Every batch pull is fault-gated and latency-recorded; on fail-stop the
    stream fails over: a fresh iterator opens on a sibling replica and
    fast-forwards past the anchor ids already yielded (streams are
    non-decreasing in anchor id and identical across replicas, so the
    filter ``ids > last_id`` resumes exactly where the dead replica
    stopped -- the merged output is byte-identical to a healthy run)."""
    rs = cdb.replica_sets[shard]
    last_id = -1
    it = None
    r = -1
    try:
        while True:
            if it is None:
                if trace is not None and r >= 0:
                    # a replica died mid-stream: the reopen-on-a-sibling +
                    # fast-forward is the failover the chaos suite asserts on
                    with trace.span("failover", shard=shard,
                                    from_replica=r) as sp:
                        it, nxt, r = _open_stream(cdb, shard, open_on,
                                                  deadline, trace=trace)
                        sp.set(to_replica=r)
                else:
                    it, nxt, r = _open_stream(cdb, shard, open_on, deadline,
                                              trace=trace)
            else:
                attempts = 0
                while True:
                    t0 = time.perf_counter()
                    try:
                        cdb.faults.check(shard, r)
                        nxt = next(it, _DONE)
                    except ReplicaDown:
                        rs.note_failure(r)
                        rs.mark_dead(r)
                        _close_quiet(it, cdb)
                        it = None
                        break
                    except ReplicaError:
                        rs.note_failure(r)
                        attempts += 1
                        cdb._count("retries")
                        if trace is not None:
                            trace.event("retry", shard=shard, replica=r,
                                        attempt=attempts, where="stream_pull")
                        if attempts > cdb.cfg.cluster.read_retries:
                            rs.mark_dead(r)
                            _close_quiet(it, cdb)
                            it = None
                            break
                        backoff = cdb.cfg.cluster.retry_backoff_s * attempts
                        if deadline is not None:
                            deadline.check("stream pull retry")
                            backoff = deadline.clamp(backoff)
                        time.sleep(backoff)
                        continue
                    dt = time.perf_counter() - t0
                    rs.note_success(r, dt)
                    cdb.stats.record_replica_read(shard, r, dt)
                    break
                if it is None:
                    continue            # reopen on a sibling + fast-forward
            if nxt is _DONE:
                return
            ids, rows = nxt
            if last_id >= 0 and len(ids) and int(ids[0]) <= last_id:
                keep = ids > last_id
                rows = [row for row, kk in zip(rows, keep) if kk]
                ids = ids[keep]
            if len(ids):
                last_id = int(ids[-1])
                yield ids, rows
    finally:
        if it is not None:
            it.close()


class _ResilientIndex:
    """Duck-typed shard view for :func:`scatter_gather_knn`: ``search_many``
    hedges across the shard's live replicas with retry + failover, so one
    merge schedule serves healthy and degraded clusters identically
    (replicas hold the same piece, so any winner returns the same rows)."""

    def __init__(self, cdb: "ReplicatedPandaDB", shard: int, sub_key: str,
                 deadline: Optional[Deadline] = None, trace=None) -> None:
        self.cdb = cdb
        self.shard = shard
        self.sub_key = sub_key
        self.deadline = deadline
        self.trace = trace
        self.scan_rows = 0
        rs = cdb.replica_sets[shard]
        piece = rs.replicas[rs.live()[0]].indexes[sub_key]
        self.n_total = piece.n_total
        self.centroids = piece.centroids
        self.cfg = piece.cfg
        self.device = piece.device      # where the merge runs

    def _search_on(self, r: int, queries, k, nprobe, mode, rerank,
                   rerank_mult=None):
        cdb, s = self.cdb, self.shard
        t0 = time.perf_counter()
        cdb.faults.check(s, r)
        db = cdb.replica_sets[s].replicas[r]
        piece = db.indexes[self.sub_key]
        rows0 = piece.scan_rows
        v, i = piece.search_many(queries, k, nprobe, stats=db.stats,
                                 mode=mode, rerank=rerank,
                                 rerank_mult=rerank_mult)
        cdb.stats.record_replica_read(s, r, time.perf_counter() - t0)
        cdb._count_replica_read(s, r)
        return v, i, piece.scan_rows - rows0

    def search_many(self, queries, k, nprobe=None, stats=None, mode="auto",
                    rerank=True, rerank_mult=None):
        cdb, s = self.cdb, self.shard
        rs = cdb.replica_sets[s]
        deadline = self.deadline
        attempts = 0
        while True:
            if deadline is not None:
                deadline.check("knn search")
            live = rs.selectable()
            try:
                (v, i, rows), r = hedged_call(
                    cdb, s, live,
                    lambda rr: self._search_on(rr, queries, k, nprobe, mode,
                                               rerank, rerank_mult),
                    deadline=deadline, trace=self.trace)
            except ReplicaDown:
                continue
            except ReplicaError:
                attempts += 1
                cdb._count("retries")
                if self.trace is not None:
                    self.trace.event("retry", shard=s, attempt=attempts,
                                     where="knn")
                if attempts > cdb.cfg.cluster.read_retries:
                    raise
                backoff = cdb.cfg.cluster.retry_backoff_s * attempts
                if deadline is not None:
                    deadline.check("knn retry")
                    backoff = deadline.clamp(backoff)
                time.sleep(backoff)
                continue
            rs.note_success(r)
            self.scan_rows += rows
            return v, i


class ReplicatedPandaDB(ShardedPandaDB):
    """:class:`ShardedPandaDB` with R replicas per shard, every replica on
    the coordinator's one ``device``.

    Same coordinator surface (sessions, kNN, CREATE, explain); the replica
    hooks route reads through latency-based replica choice + hedging +
    failover and writes through the per-shard op log."""

    def __init__(self, n_shards: Optional[int] = None,
                 cfg: Optional[PandaDBConfig] = None,
                 owner_fn=None, replication: Optional[int] = None,
                 faults: Optional[FaultInjector] = None,
                 device: DeviceLike = None) -> None:
        cfg = cfg or PandaDBConfig()
        self.replication = int(replication or cfg.cluster.replication)
        if self.replication < 1:
            raise ValueError(
                f"replication must be >= 1, got {self.replication}")
        self.faults = faults or FaultInjector(seed=0)
        self.replica_sets: List[ReplicaSet] = []
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        self._hedge_inflight: Set[Any] = set()
        self._hedge_lock = threading.Lock()
        super().__init__(n_shards, cfg, owner_fn, device=device)
        for rs in self.replica_sets:
            for db in rs.replicas:
                db.plan_cache = self.plan_cache
        if self.cfg.cluster.hedge_reads and self.replication > 1:
            # dedicated pool: hedges are issued FROM scatter-pool workers,
            # so sharing that pool could deadlock at full fan-out
            self._hedge_pool = ThreadPoolExecutor(
                max_workers=2 * self.n_shards, thread_name_prefix="hedge")

    def _make_shards(self) -> List[PandaDB]:
        # every alive->dead transition a replica set observes is a failover
        # (counters exist by first use: live() only runs post-__init__)
        on_dead = lambda s, r: self._count("failovers")  # noqa: E731
        cl = self.cfg.cluster
        self.replica_sets = [
            ReplicaSet(s, [make_shard(self.cfg, device=self.device)
                           for _ in range(self.replication)], self.faults,
                       on_dead=on_dead,
                       breaker_failures=cl.breaker_failures,
                       breaker_reset_s=cl.breaker_reset_s,
                       breaker_slow_call_s=cl.breaker_slow_call_s)
            for s in range(self.n_shards)]
        return [rs.replicas[0] for rs in self.replica_sets]

    def _track_hedge(self, fu):
        """Register an in-flight hedge leg so :meth:`close` can drain the
        legs still running on pool threads (a discard-on-done callback
        keeps the set O(open legs))."""
        with self._hedge_lock:
            self._hedge_inflight.add(fu)

        def _untrack(f) -> None:
            with self._hedge_lock:
                self._hedge_inflight.discard(f)

        fu.add_done_callback(_untrack)
        return fu

    def close(self) -> None:
        """Idempotent teardown.  ``cancel_futures=True`` drops every hedge
        leg still queued (they would otherwise run against retiring
        replicas after close returns); legs already RUNNING on a pool
        thread cannot be cancelled, so close drains them with a bounded
        wait instead of abandoning them mid-read -- a hedge landing after
        close neither deadlocks nor touches a retired replica."""
        super().close()
        pool, self._hedge_pool = self._hedge_pool, None
        if pool is None:
            return
        pool.shutdown(wait=False, cancel_futures=True)
        with self._hedge_lock:
            running = [fu for fu in self._hedge_inflight if not fu.done()]
        if running:
            wait(running, timeout=self.cfg.cluster.close_drain_s)

    def revive(self, shard: int, replica: int) -> int:
        """Heal + catch up one replica from the shard's op log (§VII-A
        rejoin).  Returns the number of ops replayed."""
        return self.replica_sets[shard].revive(replica)

    # -- replica hooks ---------------------------------------------------------

    def read_db(self, s: int) -> PandaDB:
        rs = self.replica_sets[s]
        r = self.stats.choose_replica(s, rs.selectable())
        self._count_replica_read(s, r)
        return rs.replicas[r]

    def _shard_apply(self, s: int, op: str, *args: Any, **kw: Any) -> Any:
        return self.replica_sets[s].apply(op, args, kw)

    def _shard_stream(self, plan, s, params, anchor, batch_rows, limit,
                      prefetch_depth, deadline=None, trace=None,
                      profile=None):
        rs = self.replica_sets[s]
        if profile is not None:
            profile.note_shard(s)

        def open_on(r: int):
            ctx = ExecutionContext(rs.replicas[r], params,
                                   prefetch_depth=prefetch_depth,
                                   deadline=deadline,
                                   trace=trace, profile=profile)
            return execute_iter_tagged(plan, ctx, anchor, batch_rows,
                                       limit=limit)

        return resilient_stream(self, s, open_on, deadline=deadline,
                                trace=trace)

    def knn(self, sub_key: str, queries, k: int, nprobe: Optional[int] = None,
            mode: str = "auto", rerank: bool = True,
            deadline_ms: Optional[float] = None, trace=None):
        deadline = Deadline.resolve(deadline_ms)
        own_trace = trace is None and self.tracer.enabled
        if own_trace:
            trace = self.tracer.begin("knn", sub_key=sub_key, k=k)
        views = [_ResilientIndex(self, s, sub_key, deadline=deadline,
                                 trace=trace)
                 for s in self.active]
        try:
            out = scatter_gather_knn(
                views, queries, k, nprobe=nprobe,
                mode=mode, rerank=rerank, stats=None,
                record=self.stats.record_shard_scan,
                pool=self._pool,
                split_rerank_budget=self.cfg.cluster.split_rerank_budget,
                deadline=deadline, trace=trace)
        finally:
            if own_trace and trace is not None:
                trace.finish()
        if deadline is not None and "partial_topk" in deadline.degradations:
            self._count("degraded")
        return out

    def cluster_counters(self) -> Dict[str, int]:
        out = dict(super().cluster_counters())
        opens = probes = closes = 0
        for rs in self.replica_sets:
            for b in rs.breakers:
                opens += b.opens
                probes += b.probes
                closes += b.closes
        out["breaker_opens"] = opens
        out["breaker_probes"] = probes
        out["breaker_closes"] = closes
        # mirror the breaker transition totals into the registry so the
        # Prometheus dump / global_snapshot see them without a second path
        self.metrics.gauge("breaker_opens").set(opens)
        self.metrics.gauge("breaker_probes").set(probes)
        self.metrics.gauge("breaker_closes").set(closes)
        return out

    def explain(self, text: str) -> Dict[str, Any]:
        out = super().explain(text)
        out["replication"] = self.replication
        out["alive"] = {s: list(self.replica_sets[s].alive)
                        for s in range(self.n_shards)}
        out["breakers"] = {s: [b.state for b in self.replica_sets[s].breakers]
                           for s in range(self.n_shards)}
        out["hedge_deadline_s"] = {s: self.stats.hedge_deadline(s)
                                   for s in self.active}
        return out
