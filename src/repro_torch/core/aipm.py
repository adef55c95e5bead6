"""AIPM: the AI-model interactive protocol (paper §IV-B).

AI models (sub-property extraction functions φ) are deployed *away from* the
database kernel: the query engine sends an AIPM-request, the model service
extracts the "computable pattern" (feature vector / label / text)
asynchronously in batches, and the engine caches the result.

Here the model service is an in-process registry of extractor callables,
dispatched through a bounded async queue so the protocol semantics (request /
future / batched async completion) are preserved.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.pandadb import AIPMConfig
from repro_torch.obs.trace import phases, span


@dataclasses.dataclass
class ExtractorSpec:
    """One registered φ: sub-property key -> model."""

    sub_key: str
    fn: Callable[[List[np.ndarray]], np.ndarray]   # batch of raw -> [B, ...]
    serial: int = 1
    batch_size: int = 64
    calls: int = 0
    rows: int = 0
    total_time: float = 0.0

    @property
    def avg_speed(self) -> float:
        """Observed s/row (feeds the cost model statistics)."""
        return self.total_time / self.rows if self.rows else 0.0


@dataclasses.dataclass
class AIPMRequest:
    sub_key: str
    items: List[Tuple[int, np.ndarray]]    # (item_id, raw content)
    future: Future = dataclasses.field(default_factory=Future)


PROXY_SUFFIX = "#proxy"


def proxy_key(sub_key: str) -> str:
    """Registry/cache key of the proxy tier attached to ``sub_key``.

    The suffix cannot appear in a parsed sub-property name (``->`` names are
    identifiers), so proxy entries can never alias exact entries anywhere the
    (item, sub_key, serial) key scheme is used -- SemanticCache, InflightTable,
    cost-model EWMAs all inherit the tiering for free.
    """
    return sub_key + PROXY_SUFFIX


class ModelRegistry:
    """sub-property key -> extractor; serial bumps on model update."""

    def __init__(self) -> None:
        self._extractors: Dict[str, ExtractorSpec] = {}

    def register(self, sub_key: str,
                 fn: Callable[[List[np.ndarray]], np.ndarray],
                 batch_size: int = 64) -> ExtractorSpec:
        old = self._extractors.get(sub_key)
        serial = old.serial + 1 if old else 1
        spec = ExtractorSpec(sub_key, fn, serial=serial, batch_size=batch_size)
        self._extractors[sub_key] = spec
        return spec

    def register_proxy(self, sub_key: str,
                       fn: Callable[[List[np.ndarray]], np.ndarray],
                       batch_size: int = 256) -> ExtractorSpec:
        """Attach a cheap proxy scorer to an already-registered extractor.

        The proxy is a normal extractor stored under :func:`proxy_key`, so the
        whole AIPM pipeline (async submit, batching, dedup, caching, speed
        stats) applies to it unchanged.  Its serial lineage is independent of
        the base extractor's: re-registering either tier invalidates only that
        tier's cache entries.
        """
        if sub_key.endswith(PROXY_SUFFIX):
            raise ValueError(f"cannot attach a proxy to a proxy: {sub_key!r}")
        if sub_key not in self._extractors:
            raise KeyError(
                f"no extractor registered for sub-property {sub_key!r}; "
                "register the exact φ before attaching a proxy")
        return self.register(proxy_key(sub_key), fn, batch_size=batch_size)

    def get(self, sub_key: str) -> ExtractorSpec:
        if sub_key not in self._extractors:
            raise KeyError(f"no extractor registered for sub-property {sub_key!r}")
        return self._extractors[sub_key]

    def serial(self, sub_key: str) -> int:
        return self.get(sub_key).serial

    def has_proxy(self, sub_key: str) -> bool:
        return proxy_key(sub_key) in self._extractors

    def known(self) -> List[str]:
        return list(self._extractors)


class AIPMService:
    """Bounded async request queue in front of the registry.

    ``submit`` returns a Future (the AIPM-request); a pool of ``cfg.workers``
    threads drains the queue in extractor-sized batches, so several φ batches
    can be in flight at once (the paper's model service has its own
    parallelism, away from the database kernel).  The queue is bounded at
    ``cfg.max_inflight`` -- a submitter that outruns the service blocks and
    eventually gets ``queue.Full`` (backpressure), so prefetching can never
    grow memory without bound.  A queued request whose future is cancelled
    before a worker picks it up is skipped entirely (``LIMIT`` early exit).

    ``extract_sync`` is the blocking convenience used by the executor when it
    wants the result immediately.
    """

    def __init__(self, registry: ModelRegistry,
                 cfg: Optional[AIPMConfig] = None,
                 metrics: Optional[Any] = None) -> None:
        self.registry = registry
        self.cfg = cfg or AIPMConfig()
        #: optional MetricsRegistry: per-sub_key model-call counters + batch
        #: latency histogram (the db wires its own registry in)
        self.metrics = metrics
        self._queue: "queue.Queue[Optional[AIPMRequest]]" = queue.Queue(
            maxsize=self.cfg.max_inflight)
        self.cancelled_requests = 0
        self._stats_lock = threading.Lock()   # spec counters, multi-worker
        self._shutdown = False
        self._workers = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(max(1, self.cfg.workers))]
        for w in self._workers:
            w.start()

    def _run(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                return
            if not req.future.set_running_or_notify_cancel():
                with self._stats_lock:
                    self.cancelled_requests += 1    # cancelled while queued
                continue
            try:
                req.future.set_result(self._execute(req))
            except Exception as e:  # noqa: BLE001
                req.future.set_exception(e)

    def _slice_rows(self, spec: ExtractorSpec) -> int:
        """φ slice size: observed per-row speed targets ~target_batch_s per
        model call (cost-model feedback), clamped to the protocol maximum."""
        if not self.cfg.auto_batch:
            return spec.batch_size
        from repro_torch.core.cost_model import suggest_phi_batch
        return suggest_phi_batch(spec.avg_speed, spec.batch_size,
                                 self.cfg.max_batch, self.cfg.target_batch_s)

    def _execute(self, req: AIPMRequest) -> Dict[int, np.ndarray]:
        """One request through its φ, in slices; span ``aipm.execute``
        (``sub_key``, ``rows``, ``slices``) while anything records."""
        spec = self.registry.get(req.sub_key)
        batch_rows = self._slice_rows(spec)
        out: Dict[int, np.ndarray] = {}
        t0 = time.perf_counter()
        with span(None, "aipm.execute", sub_key=req.sub_key,
                  rows=len(req.items),
                  slices=-(-len(req.items) // batch_rows)):
            for off in range(0, len(req.items), batch_rows):
                chunk = req.items[off:off + batch_rows]
                raws = [r for (_i, r) in chunk]
                vecs = np.asarray(spec.fn(raws))
                for (item_id, _r), v in zip(chunk, vecs):
                    out[item_id] = v
        dt = time.perf_counter() - t0
        with self._stats_lock:
            spec.calls += 1
            spec.rows += len(req.items)
            spec.total_time += dt
        if self.metrics is not None:
            self.metrics.counter(f"aipm_calls:{req.sub_key}").inc()
            self.metrics.counter(f"aipm_rows:{req.sub_key}").inc(
                len(req.items))
            self.metrics.histogram("aipm_batch_ms").observe(dt * 1000)
        return out

    def submit(self, sub_key: str,
               items: List[Tuple[int, np.ndarray]],
               timeout: Optional[float] = None) -> Future:
        """``timeout`` bounds the backpressure block when the bounded queue
        is full (a deadline-carrying query passes its remaining budget; the
        default is the global ``timeout_ms`` knob)."""
        if self._shutdown:
            raise RuntimeError("AIPMService is shut down")
        req = AIPMRequest(sub_key, items)
        self._queue.put(req, timeout=(self.cfg.timeout_ms / 1000
                                      if timeout is None else timeout))
        return req.future

    def extract_sync(self, sub_key: str,
                     items: List[Tuple[int, np.ndarray]],
                     timeout: Optional[float] = None) -> Dict[int, np.ndarray]:
        if timeout is None:
            timeout = self.cfg.timeout_ms / 1000
        return self.submit(sub_key, items, timeout=timeout).result(
            timeout=timeout)

    def pending(self) -> int:
        """Requests queued but not yet picked up (approximate)."""
        return self._queue.qsize()

    def _drain_cancel(self) -> None:
        """Cancel every request still sitting in the queue; never strand a
        future.  Stray stop sentinels encountered mid-drain are dropped (the
        workers they were meant for have already exited)."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is None:
                continue
            if req.future.cancel():
                with self._stats_lock:
                    self.cancelled_requests += 1
            # a future already running can't be cancelled; its worker owns it

    def shutdown(self) -> None:
        """Idempotent: stop accepting work, cancel whatever is still queued
        (counted in ``cancelled_requests``), and join the workers."""
        if self._shutdown:
            return
        self._shutdown = True
        self._drain_cancel()
        for _ in self._workers:
            self._queue.put(None)
        for w in self._workers:
            w.join(timeout=self.cfg.timeout_ms / 1000)
        self._drain_cancel()   # races: requests enqueued before the flag flip


# ---------------------------------------------------------------------------
# Built-in extractors (deterministic, content-derived -- offline container)
# ---------------------------------------------------------------------------


def feature_hash_extractor(dim: int = 128, seed: int = 0
                           ) -> Callable[[List[np.ndarray]], np.ndarray]:
    """Deterministic 'face-feature' style extractor: content -> unit vector.
    Similar content maps to similar vectors (locality via byte histograms)."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((256, dim)).astype(np.float32) / 16.0

    def fn(raws: List[np.ndarray]) -> np.ndarray:
        out = np.zeros((len(raws), dim), np.float32)
        for i, raw in enumerate(raws):
            b = np.asarray(raw, np.uint8).ravel()
            hist = np.bincount(b, minlength=256).astype(np.float32)
            hist /= max(1.0, hist.sum())
            v = hist @ proj
            out[i] = v / max(1e-9, np.linalg.norm(v))
        return out

    return fn


def label_extractor(labels: Sequence[str], seed: int = 1
                    ) -> Callable[[List[np.ndarray]], np.ndarray]:
    """'animal'/'jerseyNumber' style: content -> deterministic class label."""
    labels = list(labels)

    def fn(raws: List[np.ndarray]) -> np.ndarray:
        out = []
        for raw in raws:
            b = np.asarray(raw, np.uint8).ravel()
            h = int(b[:16].sum() + len(b)) if b.size else 0
            out.append(labels[(h + seed) % len(labels)])
        return np.asarray(out, dtype=object)

    return fn


def model_embedding_extractor(model, dim: int, max_tokens: int = 64
                              ) -> Callable[[List[np.ndarray]], np.ndarray]:
    """Adapter: use an LM (``models.transformer.LM``) as φ.  Each BLOB's
    first ``max_tokens`` bytes become tokens ``byte % vocab``, zero-padded;
    φ is the mean of the logits over all positions (padding included, as the
    reference does), cut or zero-padded to ``dim`` and L2-normalised (floor
    1e-9), as float32 numpy.  The forward runs on the model's device.

    ``fn.raw(raws)`` gives the vectors before the normalisation; ``fn``
    calls it through the attribute, so a caller that wraps it keeps the
    vectors each call normalised.  Spans ``phi.forward`` (``rows``,
    ``tokens``; the model's own inside it) and ``phi.pool`` (the mean, the
    cut, the copy to the host) in ``phi.extract`` while anything records;
    counters ``phi.calls``, ``phi.rows``, ``phi.tokens`` and the MoE
    layers' (``models/moe.py``: ``METRICS``, whose registry is "phi")."""
    from repro_torch.models import moe

    vocab = model.cfg.vocab_size

    def raw(raws: List[np.ndarray]) -> np.ndarray:
        toks = np.zeros((len(raws), max_tokens), np.int64)
        for i, blob in enumerate(raws):
            b = np.asarray(blob, np.uint8).ravel()[:max_tokens]
            toks[i, :len(b)] = b.astype(np.int64) % vocab
        with phases(None, "phi.extract") as ph, moe.counting():
            if ph:
                ph.next("phi.forward", rows=len(raws), tokens=toks.size)
            logits, _ = model.forward(torch.from_numpy(toks).to(model.device))
            if ph:
                ph.next("phi.pool")
            out = logits.mean(dim=1)[:, :dim].float().cpu().numpy()
        moe.METRICS.counter("phi.calls").inc()
        moe.METRICS.counter("phi.rows").inc(len(raws))
        moe.METRICS.counter("phi.tokens").inc(toks.size)
        return out if out.shape[1] >= dim else np.pad(
            out, [(0, 0), (0, dim - out.shape[1])])

    def fn(raws: List[np.ndarray]) -> np.ndarray:
        out = fn.raw(raws)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)

    fn.raw = raw
    return fn
