"""Semantic-information cache (paper §VI-B1, Fig 6) + in-flight dedup.

Key = (item id, sub-property key, model serial number).  One AI model == one
semantic space; when the admin updates a model, its serial bumps and every
cache entry built by older serials becomes invalid (checked lazily, purged
eagerly on demand).

The :class:`InflightTable` extends the cache's contract to extractions that
have been *requested but not yet computed*: when two sessions concurrently
need φ for the same (item, sub-property, serial), the first claims the key
and dispatches one AIPM request; the second borrows the first's future and
waits, so the model service sees each item exactly once.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.pandadb import CacheConfig

Key = Tuple[int, str, int]


class SemanticCache:
    """LRU of extracted sub-property values.  Thread-safe: AIPM completion
    callbacks populate it from worker threads while sessions read it."""

    def __init__(self, cfg: Optional[CacheConfig] = None) -> None:
        self.cfg = cfg or CacheConfig()
        self._lock = threading.RLock()
        self._data: "OrderedDict[Key, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, item_id: int, sub_key: str, serial: int) -> Optional[Any]:
        key = (item_id, sub_key, serial)
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def peek(self, item_id: int, sub_key: str, serial: int) -> Optional[Any]:
        """Like :meth:`get` but touches neither the LRU order nor the hit/miss
        counters -- used by the prefetcher to decide what to extract without
        skewing the statistics the benchmarks report."""
        with self._lock:
            return self._data.get((item_id, sub_key, serial))

    def note_misses(self, n: int) -> None:
        """Count ``n`` cold lookups observed via :meth:`peek` (the extraction
        dispatcher probes silently, then reports what it actually missed)."""
        if n > 0:
            with self._lock:
                self.misses += n

    def put(self, item_id: int, sub_key: str, serial: int, value: Any) -> None:
        key = (item_id, sub_key, serial)
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.cfg.capacity_items:
                self._data.popitem(last=False)

    def invalidate_serial(self, sub_key: str, older_than: int) -> int:
        """Purge entries for `sub_key` built by serials < `older_than`.
        Returns the number of entries dropped (paper Fig 6: cache entries with
        a stale serial are out of date)."""
        with self._lock:
            stale = [k for k in self._data
                     if k[1] == sub_key and k[2] < older_than]
            for k in stale:
                del self._data[k]
            return len(stale)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "entries": len(self._data),
            }

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = self.misses = 0


class InflightTable:
    """Dedup of φ extraction requests currently in flight.

    ``claim`` partitions a set of keys into *owned* (this caller registered a
    fresh future and must dispatch + later resolve/fail/discard it) and
    *borrowed* (another caller's extraction is already in flight; wait on its
    future instead of re-submitting).  A borrowed future that gets cancelled
    (the owner's cursor hit ``LIMIT`` and bailed) signals the borrower to
    re-extract on its own -- nothing ever waits forever on an abandoned key.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._futures: Dict[Key, Future] = {}
        self.dedup_hits = 0      # borrowed claims: φ calls saved

    def claim(self, keys: Sequence[Key]
              ) -> Tuple[List[Tuple[Key, Future]], Dict[Key, Future]]:
        owned: List[Tuple[Key, Future]] = []
        borrowed: Dict[Key, Future] = {}
        with self._lock:
            for k in keys:
                f = self._futures.get(k)
                if f is not None and not f.done():
                    borrowed[k] = f
                    self.dedup_hits += 1
                else:
                    nf: Future = Future()
                    self._futures[k] = nf
                    owned.append((k, nf))
        return owned, borrowed

    def _pop(self, key: Key) -> Optional[Future]:
        with self._lock:
            return self._futures.pop(key, None)

    def resolve(self, key: Key, value: Any) -> None:
        f = self._pop(key)
        if f is not None and not f.done():
            f.set_result(value)

    def fail(self, key: Key, exc: BaseException) -> None:
        f = self._pop(key)
        if f is not None and not f.done():
            f.set_exception(exc)

    def discard(self, key: Key) -> None:
        """Abandon a claim (owner cancelled before the extraction ran).
        Borrowers observe the cancellation and re-submit for themselves."""
        f = self._pop(key)
        if f is not None:
            f.cancel()

    def size(self) -> int:
        with self._lock:
            return len(self._futures)
