"""Semantic-information vector index: IVF-Flat / IVF-PQ (paper §VI-B2 +
Algorithm 2, extended with product-quantized storage), on a torch device.

BatchIndexing: m = |S| / 100_000 buckets (empirical value from the paper),
random core vectors refined by a few k-means iterations, every vector
assigned to its nearest core.  DynamicIndexing: new vectors land in
per-bucket append buffers (amortized O(1) per insert) and are folded into
the sorted bucket layout by a deferred compaction pass; searches always see
the uncompacted rows.  kNN: queries are batched -- one centroid probe for
the whole query set, then queries sharing a probe signature are scanned
together through ``kernels.ivf_scan.ops.ivf_scan_topk`` (the CUDA kernel on
the card, its plain version on the CPU) over the probed buckets' rows,
gathered on the device.  There is no per-query Python loop.

The index lives on one device (``device=``, default the CUDA card).  The
compacted ``vectors``, ``ids``, ``codes``, ``bucket_of``, ``code_bias`` and
the centroids are kept resident there and refreshed after ``build``,
``compact``, ``insert_many`` and ``retrain_pq``; each scan gathers its
buckets with ``index_select`` on the device instead of uploading the table,
and the float scans map their selected rows to ids there too, so only the
answers come back.  Numpy mirrors of the same arrays serve the host
bookkeeping, the exact re-rank and the single-query host path.

IVF-PQ (``cfg.pq_m > 0``): :class:`PQCodebook` trains per-subspace k-means
codebooks at build time and every bucket stores uint8 codes (M bytes per
row instead of 4*dim).  Search is two-stage: per-query score LUTs + an
asymmetric-distance (ADC) top-k' scan of the probed buckets through
``kernels.pq_scan.ops.pq_adc_topk``, then an exact re-rank of the k'
candidates against the original float vectors that returns true top-k
scores.  The cost model picks ADC vs float scan per query batch from
observed throughputs (``StatisticsService.choose_knn_scan``).

Distributed layout (paper §VII-A: property data sharded): centroids are
replicated, bucket contents are sharded (:meth:`IVFIndex.shard`); a query
does a local scan per shard, then the per-shard top-k windows meet in one
k-way merge on the shards' device -- :func:`scatter_gather_knn`, which runs
the ``topk_merge`` CUDA kernel on the card.  ``ShardedPandaDB.knn``,
``ReplicatedPandaDB.knn`` and :func:`distributed_knn` all go through it.

Observability: ``search_many(..., trace=)`` opens ``ivf.*`` spans
(``ivf.search`` around ``ivf.probe``, ``ivf.group``, ``ivf.gather``,
``ivf.scan``, ``ivf.fetch``, ``ivf.map``, and ``ivf.luts`` /
``ivf.rerank`` on the PQ paths, ``ivf.search_one`` for one query) through
:func:`repro_torch.obs.trace.phases`, which also mirrors them onto the
torch profiler's timeline while it records, and costs one truth test a
step when nothing records.  :data:`METRICS` counts batches,
queries, probe signatures, the path taken and the bytes the search path
copies between host and device, always on.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from concurrent.futures import wait as futures_wait
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.configs.pandadb import VectorIndexConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.topk import stable_topk
from repro_torch.kernels.topk_merge.ops import merge_topk_dev
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import phases

#: the index's counters, on the process roster (``launch/serve.py
#: --metrics``): ``ivf.batches`` and ``ivf.queries`` (calls that search),
#: ``ivf.signatures`` (distinct probe signatures), ``ivf.path.<path>``
#: (batches by the path taken), ``ivf.h2d_bytes`` / ``ivf.d2h_bytes`` (the
#: search path's explicit copies; table uploads are not counted)
METRICS = MetricsRegistry("vector_index")
PATHS = ("one", "grouped", "dense", "adc", "fused")
_BATCHES = METRICS.counter("ivf.batches")
_QUERIES = METRICS.counter("ivf.queries")
_SIGNATURES = METRICS.counter("ivf.signatures")
_H2D = METRICS.counter("ivf.h2d_bytes")
_D2H = METRICS.counter("ivf.d2h_bytes")
_PATH = {p: METRICS.counter(f"ivf.path.{p}") for p in PATHS}


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A search result on the host (waits on the device); its bytes are
    counted in ``ivf.d2h_bytes``."""
    a = t.cpu().numpy()
    _D2H.inc(a.nbytes)
    return a


def _map_ids(ids: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The ids of the selected rows: ``ids[idx]`` for [Q, k] positions
    into the scanned rows, gathered on their device."""
    return torch.index_select(ids, 0, idx.reshape(-1)).view(idx.shape)


def _group_signatures(probe: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sigs, inverse) of a [Q, nprobe] probe: its distinct rows in
    ascending lexicographic order and, per query, its row of ``sigs``
    (int64, ``sigs[inverse] == probe``), as ``np.unique(probe, axis=0,
    return_inverse=True)`` gives them, by one lexsort on the columns (the
    first primary): ``np.unique`` with an axis sorts a structured view by
    a field-by-field compare, several times slower on the host while the
    card waits."""
    order = np.lexsort(probe.T[::-1])
    rows = probe[order]
    start = np.empty(len(rows), bool)
    start[:1] = True
    np.any(rows[1:] != rows[:-1], axis=1, out=start[1:])
    inverse = np.empty(len(rows), np.int64)
    inverse[order] = np.cumsum(start) - 1
    return rows[start], inverse


# ---------------------------------------------------------------------------
# scoring primitives
# ---------------------------------------------------------------------------


def pairwise_scores(q: torch.Tensor, c: torch.Tensor, metric: str
                    ) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N]; higher is better."""
    if metric == "ip":
        return q @ c.T
    if metric == "cosine":
        qn = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-9)
        cn = c / torch.clamp_min(
            torch.linalg.vector_norm(c, dim=-1, keepdim=True), 1e-9)
        return qn @ cn.T
    # l2: negative squared distance via the matmul identity
    q2 = torch.sum(q * q, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return -(q2 - 2.0 * (q @ c.T) + c2[None, :])


def _pairwise_scores_np(q: np.ndarray, c: np.ndarray, metric: str) -> np.ndarray:
    """Host-side twin of :func:`pairwise_scores` for tiny shapes (insert's
    centroid pick), where one device dispatch would dominate the work."""
    q = np.asarray(q, np.float32)
    c = np.asarray(c, np.float32)
    if metric == "ip":
        return q @ c.T
    if metric == "cosine":
        qn = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
        cn = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-9)
        return qn @ cn.T
    q2 = np.sum(q * q, axis=-1, keepdims=True)
    c2 = np.sum(c * c, axis=-1)
    return -(q2 - 2.0 * (q @ c.T) + c2[None, :])


def scan_topk(q: torch.Tensor, corpus: torch.Tensor, ids: torch.Tensor,
              k: int, metric: str = "l2"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scored top-k of `corpus` rows for each query row."""
    scores = pairwise_scores(q, corpus, metric)
    vals, idx = stable_topk(scores, min(k, corpus.shape[0]))
    return vals, ids[idx]


def merge_topk(vals_parts: torch.Tensor, ids_parts: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k: [P, Q, k] -> [Q, k] (associative), through
    :func:`merge_topk_dev` over every column (the kernel on the card).

    Padding entries (val=-inf, id=-1) sink to the tail of the merge; callers
    that may hold fewer than ``k`` real candidates in total should truncate
    or mask afterwards (see :func:`distributed_knn`)."""
    return merge_topk_dev(vals_parts, ids_parts, k)


def stable_id_hash(ids: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over external ids: the cluster-wide ownership
    hash.  Stable under row reordering (it sees the *id*, not the row
    position), so compaction / rebuilds never move a row between shards."""
    x = np.asarray(ids).astype(np.uint64)
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def owner_shard(ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Owning shard per external id: ``stable_id_hash(id) % n_shards``."""
    return (stable_id_hash(ids) % np.uint64(max(1, n_shards))).astype(np.int64)


def scatter_gather_knn(shards: Sequence["IVFIndex"], queries: np.ndarray,
                       k: int, nprobe: Optional[int] = None,
                       mode: str = "auto", rerank: bool = True,
                       stats=None, record: Optional[Callable] = None,
                       pool=None, split_rerank_budget: bool = False,
                       deadline=None, trace=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """THE cluster merge schedule: per-shard ``search_many`` (ADC, float or
    fused, per each shard's cost-model call) -> one k-way ``merge_topk_dev``
    reduce on the shards' device (the ``topk_merge`` CUDA kernel on the
    card, its plain version on the CPU) -> truncation of shard padding to
    min(k, total rows).  Every scatter-gather kNN -- ``ShardedPandaDB.knn``,
    ``ReplicatedPandaDB.knn``, :func:`distributed_knn`, the serving path --
    routes through here, so the merge semantics cannot drift.

    Output invariant (the ``merge_topk`` padding contract, enforced here
    rather than trusted): a position holds id=-1 exactly where its value is
    -inf, i.e. where fewer real candidates existed than ``k`` -- no shard's
    -1 padding can ever surface with a finite score attached.

    ``stats`` is either one StatisticsService (shared feedback) or a
    sequence with one entry per shard (each shard's ADC-vs-float choice then
    uses its own observed throughputs).  ``record(shard_idx, dt, rows)``,
    if given, receives per-shard wall time + rows scanned (the
    coordinator's per-shard EWMAs).  ``pool`` is an optional
    ``concurrent.futures`` executor: shards scatter in parallel; results
    are merged in shard order either way, so the output is deterministic.

    ``split_rerank_budget=True`` divides the *global* re-rank candidate
    budget across shards -- each shard scans ADC top-``ceil(rerank_mult/P)
    * k`` instead of ``rerank_mult * k`` -- so total exact-re-rank work
    stays constant as shards are added.

    ``deadline`` (a :class:`~repro_torch.core.deadline.Deadline`, optional)
    is the degradation ladder's last resort: shards whose scans miss the
    remaining budget are *dropped* and the merge returns partial top-k
    from the shards that answered -- the padding contract above guarantees
    dropped contributions surface as (-inf, -1) slots, never as fabricated
    candidates.  ``partial_topk`` is noted on the deadline; if NO shard
    answers in time, :class:`DeadlineExceeded` is raised.

    ``trace`` (a :class:`repro_torch.obs.Trace`, optional) records one
    ``knn.shard_scan`` span per shard (attributed with rows scanned and
    re-rank mode, correct even off pool threads), a ``knn.merge`` span for
    the device-side reduce, and a ``degradation`` event when the partial
    top-k ladder step fires."""
    queries = np.asarray(queries, np.float32)
    qn = queries.shape[0]
    out_v = np.full((qn, k), -np.inf, np.float32)
    out_i = np.full((qn, k), -1, np.int64)
    if qn == 0 or not shards:
        return out_v, out_i
    per_stats = (list(stats) if isinstance(stats, (list, tuple))
                 else [stats] * len(shards))
    rm = None
    if split_rerank_budget and rerank and len(shards) > 1:
        rm = max(1, -(-max(sh.cfg.rerank_mult for sh in shards)
                      // len(shards)))

    # spans from pool threads attach to the caller's current span, captured
    # here (the pool thread's own stack is empty, so parent= is explicit)
    t_parent = trace.current() if trace is not None else None

    def scan_one(s: int):
        t0 = time.perf_counter()
        rows0 = shards[s].scan_rows
        v, i = shards[s].search_many(queries, k, nprobe, stats=per_stats[s],
                                     mode=mode, rerank=rerank,
                                     rerank_mult=rm)
        dt = time.perf_counter() - t0
        scanned = shards[s].scan_rows - rows0
        if trace is not None:
            trace.add_timed("knn.shard_scan", dt, parent=t_parent, shard=s,
                            rows=int(scanned), rerank=rerank)
        if record is not None:
            record(s, dt, scanned)
        return v, i

    pad = (np.full((qn, k), -np.inf, np.float32),
           np.full((qn, k), -1, np.int64))
    if pool is not None and len(shards) > 1:
        if deadline is None:
            parts = list(pool.map(scan_one, range(len(shards))))
        else:
            futs = [pool.submit(scan_one, s) for s in range(len(shards))]
            futures_wait(futs, timeout=max(0.0, deadline.remaining()))
            parts, answered = [], 0
            for f in futs:
                if f.done() and f.exception() is None:
                    parts.append(f.result())
                    answered += 1
                else:
                    f.cancel()      # queued legs are withdrawn; running
                    parts.append(pad)   # legs finish unobserved
            if answered == 0:
                deadline.check("knn scatter")
            if answered < len(shards):
                deadline.note_degradation("partial_topk")
                if trace is not None:
                    trace.event("degradation", parent=t_parent,
                                step="partial_topk",
                                answered=answered, shards=len(shards))
    elif deadline is not None:
        parts, answered = [], 0
        for s in range(len(shards)):
            if deadline.expired():
                if answered == 0:
                    deadline.check("knn scatter")
                parts.append(pad)   # serial last resort: keep what we have
                continue
            parts.append(scan_one(s))
            answered += 1
        if answered < len(shards):
            deadline.note_degradation("partial_topk")
            if trace is not None:
                trace.event("degradation", parent=t_parent,
                            step="partial_topk", answered=answered,
                            shards=len(shards))
    else:
        parts = [scan_one(s) for s in range(len(shards))]
    t_merge = time.perf_counter()
    dev = shards[0].device
    v, i = merge_topk_dev(
        torch.from_numpy(np.stack([p[0] for p in parts])).to(dev),
        torch.from_numpy(np.stack([p[1] for p in parts])).to(dev), k)
    v, i = v.cpu().numpy(), i.cpu().numpy()
    if trace is not None:
        trace.add_timed("knn.merge", time.perf_counter() - t_merge,
                        parent=t_parent, shards=len(parts), k=k)
    total = sum(sh.n_total for sh in shards)
    kk = min(k, total, v.shape[1])
    v = v[:, :kk]
    out_v[:, :kk] = v
    # pin the padding invariant structurally: wherever the merged window
    # still holds -inf (a query whose probed buckets had < k real rows
    # in total), the id is -1 -- whatever payload the shard windows carried
    out_i[:, :kk] = np.where(np.isfinite(v), i[:, :kk], -1)
    return out_v[:, :k], out_i[:, :k]


def flat_shard_view(corpus: np.ndarray, ids: np.ndarray, metric: str = "l2",
                    pq: Optional["PQCodebook"] = None,
                    codes: Optional[np.ndarray] = None,
                    device: DeviceLike = None) -> "IVFIndex":
    """Wrap raw (corpus, ids) arrays as a single-bucket :class:`IVFIndex`
    on ``device`` (default: the CUDA card), so loose shards ride the same
    scan + merge machinery as built indexes (cosine rows are normalized
    exactly as :meth:`IVFIndex.build` would)."""
    corpus = np.asarray(corpus, np.float32)
    if metric == "cosine" and corpus.size:
        corpus = corpus / np.maximum(
            np.linalg.norm(corpus, axis=-1, keepdims=True), 1e-9)
    n, dim = corpus.shape
    cfg = VectorIndexConfig(dim=dim, metric=metric, min_buckets=1,
                            vectors_per_bucket=max(1, n), nprobe=1)
    return IVFIndex(cfg, np.zeros((1, dim), np.float32),
                    np.zeros(n, np.int64), corpus,
                    np.asarray(ids), pq=pq, codes=codes, device=device)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def distributed_knn(q, corpus_shards: Sequence, id_shards: Sequence, k: int,
                    metric: str = "l2", mode: str = "float",
                    pq: Optional["PQCodebook"] = None,
                    code_shards: Optional[Sequence[np.ndarray]] = None,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference collective schedule: local scan -> local top-k -> merge,
    with every shard a :func:`flat_shard_view` on ``device``.

    A thin wrapper over :func:`scatter_gather_knn` -- the cluster merge
    path -- so this host-loop reference and ``ShardedPandaDB`` can never
    drift.  ``mode="adc"`` with ``pq`` + ``code_shards`` runs the PQ
    two-stage scan per shard (ADC top-k' + exact re-rank, returned scores
    exact).  The output ([Q, k'] host tensors, k' = min(k, total rows)) is
    truncated, so the -1/-inf padding a small shard contributes can never
    leak into caller-visible results."""
    views = []
    for s, (shard, ids) in enumerate(zip(corpus_shards, id_shards)):
        codes = code_shards[s] if code_shards is not None else None
        views.append(flat_shard_view(_host(shard), _host(ids), metric, pq=pq,
                                     codes=codes, device=device))
    v, i = scatter_gather_knn(views, _host(q).astype(np.float32), k,
                              nprobe=1, mode=mode)
    total = sum(int(_host(s).shape[0]) for s in corpus_shards)
    kk = min(k, total)
    return (torch.from_numpy(np.ascontiguousarray(v[:, :kk])),
            torch.from_numpy(np.ascontiguousarray(i[:, :kk])))


# ---------------------------------------------------------------------------
# product quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PQCodebook:
    """Per-subspace k-means codebooks: dim splits into ``m`` contiguous
    subspaces of ``dsub`` dims, each quantized to one of ``ksub = 2**bits``
    centers.  A vector becomes ``m`` uint8 codes.

    Codes are always assigned by nearest center in L2 regardless of the
    search metric; the *LUTs* carry the metric: negative squared
    sub-distances for L2, sub dot products for IP (cosine callers normalize
    upstream, then IP == cosine)."""

    codebooks: np.ndarray        # [m, ksub, dsub] float32
    metric: str = "l2"

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def nbytes(self) -> int:
        return int(self.codebooks.nbytes)

    @staticmethod
    def train(vectors: np.ndarray, m: int, bits: int = 8, iters: int = 6,
              metric: str = "l2", seed: int = 0) -> "PQCodebook":
        """Lloyd k-means per subspace (init: random corpus rows)."""
        vectors = np.asarray(vectors, np.float32)
        n, dim = vectors.shape
        if dim % m:
            raise ValueError(f"dim {dim} not divisible by pq_m {m}")
        if not 1 <= bits <= 8:
            raise ValueError(f"pq_bits must be in [1, 8] (uint8 codes), "
                             f"got {bits}")
        ksub = min(1 << bits, n)
        dsub = dim // m
        rng = np.random.default_rng(seed)
        books = np.empty((m, ksub, dsub), np.float32)
        subs = vectors.reshape(n, m, dsub)
        for j in range(m):
            sv = subs[:, j, :]
            centers = sv[rng.choice(n, size=ksub, replace=False)].copy()
            for _ in range(iters):
                assign = _nearest_l2(sv, centers)
                for c in range(ksub):
                    sel = assign == c
                    if sel.any():
                        centers[c] = sv[sel].mean(axis=0)
            books[j] = centers
        return PQCodebook(books, metric=metric)

    def encode(self, vectors: np.ndarray) -> np.ndarray:
        """[N, dim] -> uint8 codes [N, m] (nearest L2 center per subspace)."""
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        subs = vectors.reshape(n, self.m, self.dsub)
        codes = np.empty((n, self.m), np.uint8)
        for j in range(self.m):
            codes[:, j] = _nearest_l2(subs[:, j, :], self.codebooks[j])
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint8 codes [N, m] -> reconstructed vectors [N, dim]."""
        codes = np.asarray(codes)
        parts = [self.codebooks[j][codes[:, j].astype(np.int64)]
                 for j in range(self.m)]
        return np.concatenate(parts, axis=1)

    def luts(self, queries: np.ndarray) -> np.ndarray:
        """[Q, dim] -> score LUTs [Q, m, ksub], higher = better.  The ADC
        scan then evaluates s[q, n] = sum_j lut[q, j, codes[n, j]]."""
        queries = np.asarray(queries, np.float32)
        qn = queries.shape[0]
        qsubs = queries.reshape(qn, self.m, self.dsub)
        ip = np.einsum("qmd,mkd->qmk", qsubs, self.codebooks,
                       dtype=np.float32)
        if self.metric == "ip":
            return np.ascontiguousarray(ip, np.float32)
        q2 = np.sum(qsubs * qsubs, axis=-1)[:, :, None]
        c2 = np.sum(self.codebooks * self.codebooks, axis=-1)[None, :, :]
        return np.ascontiguousarray(-(q2 - 2.0 * ip + c2), np.float32)


def _nearest_l2(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """argmin_c ||x - c||^2 via the matmul identity; [N, d] x [K, d] -> [N]."""
    c2 = np.sum(centers * centers, axis=-1)
    d = c2[None, :] - 2.0 * (x @ centers.T)
    return d.argmin(axis=1)


def _residual_bias(pq: PQCodebook, codes: np.ndarray, centroids: np.ndarray,
                   buckets: np.ndarray, metric: str) -> np.ndarray:
    """Per-row additive constant of the residual-PQ score decomposition

        s(q, row) = cterm[q, bucket] + sum_j lut[q, j, code_j] + bias[row]

    For L2 it is ``-2 c_b . r_hat - ||r_hat||^2`` (r_hat = decode(codes));
    for ip/cosine the bias is zero."""
    n = len(codes)
    if metric != "l2":
        return np.zeros(n, np.float32)
    r = pq.decode(codes)                                     # [N, d]
    c = centroids[np.asarray(buckets).astype(np.int64)]      # [N, d]
    return (-2.0 * np.einsum("nd,nd->n", c, r)
            - np.einsum("nd,nd->n", r, r)).astype(np.float32)


def _pq_metric(cfg: VectorIndexConfig) -> str:
    """The LUT metric the codebooks are trained for: residual codes and
    ip/cosine search use sub dot products, plain l2 negative distances."""
    if cfg.pq_residual or cfg.metric in ("ip", "cosine"):
        return "ip"
    return "l2"


# ---------------------------------------------------------------------------
# IVF-Flat / IVF-PQ
# ---------------------------------------------------------------------------


class _Rows(NamedTuple):
    """Pending rows, stacked: bucket (int64), vectors (float32 [n, d]),
    ids (int64), codes (uint8 [n, pq_m]; PQ mode) and bias (float32;
    residual PQ)."""
    bucket: np.ndarray
    vectors: np.ndarray
    ids: np.ndarray
    codes: Optional[np.ndarray]
    bias: Optional[np.ndarray]


class _PendingRows:
    """DynamicIndexing's append buffer: the rows inserted since the last
    compaction, in arrival order.  A scan set lists them after the
    compacted rows, bucket by bucket in ascending order and in arrival
    order within a bucket -- the order :meth:`rows` gives -- so that ties,
    and the ids they return, come out as in the reference."""

    def __init__(self) -> None:
        self._parts: List[_Rows] = []
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add(self, buckets, vectors, ids, codes=None, bias=None) -> None:
        """Append rows in the order given (arrays with one entry a row)."""
        part = _Rows(np.asarray(buckets, np.int64),
                     np.asarray(vectors, np.float32),
                     np.asarray(ids, np.int64),
                     None if codes is None else np.asarray(codes, np.uint8),
                     None if bias is None else np.asarray(bias, np.float32))
        self._parts.append(part)
        self._n += len(part.bucket)

    def rows(self, buckets=None) -> Optional[_Rows]:
        """The rows of ``buckets`` (ascending; every row when None), in
        ascending bucket order and arrival order within a bucket, or None
        when there are none."""
        if not self._n:
            return None
        cols = [None if col[0] is None else np.concatenate(col)
                for col in zip(*self._parts)]
        bucket = cols[0]
        sel = (np.arange(len(bucket)) if buckets is None
               else np.flatnonzero(np.isin(bucket, buckets)))
        if not len(sel):
            return None
        order = sel[np.argsort(bucket[sel], kind="stable")]
        return _Rows(*(None if c is None else c[order] for c in cols))

    def clear(self) -> None:
        self._parts = []
        self._n = 0


@dataclasses.dataclass
class IVFIndex:
    cfg: VectorIndexConfig
    centroids: np.ndarray                 # [m, d]
    bucket_of: np.ndarray                 # [N] bucket id per vector (sorted)
    vectors: np.ndarray                   # [N, d] compacted rows
    ids: np.ndarray                       # [N] external ids
    serial: int = 1                       # model serial this index was built for
    # IVF-PQ mode (cfg.pq_m > 0): trained codebooks + uint8 codes aligned
    # row-for-row with ``vectors``; residual mode's ``code_bias`` carries
    # each row's precomputed score constant
    pq: Optional[PQCodebook] = None
    codes: Optional[np.ndarray] = None    # [N, pq_m] uint8
    code_bias: Optional[np.ndarray] = None  # [N] f32 (residual mode only)
    # rows scanned (feeds the cost model's kNN term with each scan's time)
    scan_rows: int = 0
    # where the scan-resident tables live (None: the CUDA card)
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        # dynamic-insert rows; searches always include them, compaction
        # folds them into the sorted layout
        self._pending = _PendingRows()
        self._refresh_device()

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(self.device)

    def _upload(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """:meth:`_to_device` for the search path: its bytes are counted in
        ``ivf.h2d_bytes``."""
        t = self._to_device(a, dtype)
        _H2D.inc(t.nbytes)
        return t

    def _refresh_device(self) -> None:
        """Upload the compacted tables: the scans read only these."""
        self.vectors = np.ascontiguousarray(self.vectors, np.float32)
        self.t_centroids = self._to_device(np.asarray(self.centroids,
                                                      np.float32))
        self.t_vectors = self._to_device(self.vectors)
        self.t_ids = self._to_device(np.asarray(self.ids), np.int64)
        self.t_bucket32 = self._to_device(np.asarray(self.bucket_of),
                                          np.int32)
        self.t_codes = (None if self.codes is None
                        else self._to_device(np.asarray(self.codes),
                                             np.uint8))
        self.t_bias = (None if self.code_bias is None
                       else self._to_device(np.asarray(self.code_bias),
                                            np.float32))

    @property
    def pending_count(self) -> int:
        """Rows inserted since the last compaction."""
        return len(self._pending)

    @property
    def n_total(self) -> int:
        """Indexed vectors, compacted + pending."""
        return int(self.ids.shape[0]) + self.pending_count

    def index_bytes(self) -> int:
        """Scan-resident bytes: what a bucket scan actually streams.  PQ
        mode streams uint8 codes (+ codebooks + centroids); flat mode
        streams the float32 rows."""
        base = int(self.centroids.nbytes)
        if self.pq is not None and self.codes is not None:
            pend = self.pending_count * self.pq.m
            return base + int(self.codes.nbytes) + pend + self.pq.nbytes
        pend = self.pending_count * self.vectors.shape[1] * 4
        return base + int(self.vectors.nbytes) + pend

    # -- state exchange ---------------------------------------------------------

    def to_state(self) -> Dict[str, np.ndarray]:
        """The index as numpy arrays: compacted tables, codebooks and the
        pending append buffers (flattened in bucket order)."""
        state = {"centroids": np.asarray(self.centroids, np.float32),
                 "bucket_of": np.asarray(self.bucket_of),
                 "vectors": self.vectors, "ids": np.asarray(self.ids)}
        if self.pq is not None:
            state["codebooks"] = self.pq.codebooks
            state["codes"] = np.asarray(self.codes, np.uint8)
        if self.code_bias is not None:
            state["code_bias"] = np.asarray(self.code_bias, np.float32)
        pend = self._pending.rows()
        if pend is not None:
            state["pend_bucket"] = pend.bucket
            state["pend_vectors"] = pend.vectors
            state["pend_ids"] = pend.ids
            if pend.codes is not None:
                state["pend_codes"] = pend.codes
            if pend.bias is not None:
                state["pend_bias"] = pend.bias
        return state

    @staticmethod
    def from_state(state: Dict[str, np.ndarray],
                   cfg: VectorIndexConfig, device: DeviceLike = None,
                   serial: int = 1) -> "IVFIndex":
        """An index over exactly the given arrays (the keys of
        :meth:`to_state`); pending rows (``pend_*``) arrive in the order
        given."""
        pq = None
        if "codebooks" in state:
            pq = PQCodebook(np.asarray(state["codebooks"], np.float32),
                            metric=_pq_metric(cfg))
        index = IVFIndex(
            cfg, np.asarray(state["centroids"], np.float32),
            np.asarray(state["bucket_of"]),
            np.asarray(state["vectors"], np.float32),
            np.asarray(state["ids"]), serial=serial, pq=pq,
            codes=(None if "codes" not in state
                   else np.asarray(state["codes"], np.uint8)),
            code_bias=(None if "code_bias" not in state
                       else np.asarray(state["code_bias"], np.float32)),
            device=device)
        if "pend_bucket" in state:
            index._pending.add(state["pend_bucket"], state["pend_vectors"],
                               state["pend_ids"], state.get("pend_codes"),
                               state.get("pend_bias"))
        return index

    # -- Algorithm 2: BatchIndexing -------------------------------------------

    @staticmethod
    def build(vectors: np.ndarray, ids: Optional[np.ndarray] = None,
              cfg: Optional[VectorIndexConfig] = None, serial: int = 1,
              seed: int = 0, device: DeviceLike = None) -> "IVFIndex":
        dev = resolve_device(device)
        cfg = cfg or VectorIndexConfig(dim=vectors.shape[1])
        n = vectors.shape[0]
        ids = np.arange(n) if ids is None else np.asarray(ids)
        m = max(cfg.min_buckets, n // cfg.vectors_per_bucket)
        m = min(m, max(1, n))
        rng = np.random.default_rng(seed)
        # random core vectors (paper lines 13-16) ...
        cores = vectors[rng.choice(n, size=m, replace=False)].astype(np.float32)
        # ... plus a few k-means refinements; assignments on the device,
        # centroid means on the host (the reference's arithmetic)
        v = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)).to(dev)

        def assign_all() -> np.ndarray:
            c = torch.from_numpy(cores).to(dev)
            return torch.argmax(pairwise_scores(v, c, cfg.metric),
                                dim=1).cpu().numpy()

        for _ in range(cfg.kmeans_iters):
            assign = assign_all()
            for b in range(m):
                sel = assign == b
                if sel.any():
                    cores[b] = vectors[sel].mean(axis=0)
        assign = assign_all()
        del v
        order = np.argsort(assign, kind="stable")
        sorted_vecs = np.asarray(vectors, np.float32)[order]
        if cfg.metric == "cosine":
            # normalize once so PQ codes / IP LUTs realize cosine exactly
            sorted_vecs = sorted_vecs / np.maximum(
                np.linalg.norm(sorted_vecs, axis=-1, keepdims=True), 1e-9)
        pq = codes = bias = None
        if cfg.pq_m > 0:
            train_rows = sorted_vecs
            if cfg.pq_residual:
                # quantize the residual vector - centroid[bucket]
                train_rows = sorted_vecs - cores[assign[order]]
            pq = PQCodebook.train(
                train_rows, cfg.pq_m, bits=cfg.pq_bits,
                iters=cfg.pq_kmeans_iters, metric=_pq_metric(cfg), seed=seed)
            codes = pq.encode(train_rows)
            if cfg.pq_residual:
                bias = _residual_bias(pq, codes, cores, assign[order],
                                      cfg.metric)
        return IVFIndex(cfg, cores, assign[order], sorted_vecs, ids[order],
                        serial=serial, pq=pq, codes=codes, code_bias=bias,
                        device=dev)

    # -- Algorithm 2: DynamicIndexing ------------------------------------------

    def insert(self, vec: np.ndarray, ext_id: int) -> int:
        """PickBucket + buffered append (dynamic build for new items).

        Amortized O(1) array work per insert: the vector joins its bucket's
        append buffer and the sorted layout is rebuilt only when the pending
        set crosses the compaction threshold (``pending_compact_frac``)."""
        vec = np.asarray(vec, np.float32)
        if self.cfg.metric == "cosine":
            vec = vec / max(float(np.linalg.norm(vec)), 1e-9)
        scores = _pairwise_scores_np(vec[None], self.centroids,
                                     self.cfg.metric)[0]
        b = int(scores.argmax())
        code = bias = None
        if self.pq is not None:
            enc = vec[None]
            if self.cfg.pq_residual:
                enc = enc - self.centroids[b][None]
            code = self.pq.encode(enc)
            if self.cfg.pq_residual:
                bias = _residual_bias(self.pq, code, self.centroids,
                                      np.asarray([b]), self.cfg.metric)
        self._pending.add([b], vec[None], [ext_id], code, bias)
        if self.pending_count >= self._compact_threshold():
            self.compact()
        return b

    def insert_many(self, vecs: np.ndarray, ext_ids: np.ndarray) -> np.ndarray:
        """Batched DynamicIndexing: one centroid scoring for all vectors,
        on the device."""
        vecs = np.asarray(vecs, np.float32)
        if self.cfg.metric == "cosine":
            vecs = vecs / np.maximum(
                np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-9)
        assign = torch.argmax(pairwise_scores(
            self._to_device(vecs), self.t_centroids, self.cfg.metric),
            dim=1).cpu().numpy()
        codes = bias = None
        if self.pq is not None:
            enc = vecs
            if self.cfg.pq_residual:
                enc = vecs - self.centroids[assign]
            codes = self.pq.encode(enc)
            if self.cfg.pq_residual:
                bias = _residual_bias(self.pq, codes, self.centroids,
                                      assign, self.cfg.metric)
        self._pending.add(assign, vecs, ext_ids, codes, bias)
        if self.pending_count >= self._compact_threshold():
            self.compact()
        return assign

    def _compact_threshold(self) -> int:
        return max(self.cfg.pending_compact_min,
                   int(self.cfg.pending_compact_frac * len(self.ids)))

    def compact(self) -> None:
        """Fold append buffers into the sorted bucket layout (one stable
        argsort over the concatenation; preserves ``bucket_slice``), then
        refresh the device tables."""
        pend = self._pending.rows()
        if pend is None:
            return
        bucket_of = np.concatenate(
            [self.bucket_of, pend.bucket.astype(self.bucket_of.dtype)])
        order = np.argsort(bucket_of, kind="stable")
        self.bucket_of = bucket_of[order]
        self.vectors = np.concatenate([self.vectors, pend.vectors])[order]
        self.ids = np.concatenate(
            [self.ids, pend.ids.astype(self.ids.dtype)])[order]
        if self.pq is not None and self.codes is not None:
            self.codes = np.concatenate([self.codes, pend.codes])[order]
        if self.code_bias is not None:
            self.code_bias = np.concatenate(
                [self.code_bias, pend.bias])[order]
        self._pending.clear()
        self._refresh_device()

    # -- kNN search -------------------------------------------------------------

    def bucket_slice(self, b: int) -> Tuple[int, int]:
        lo = int(np.searchsorted(self.bucket_of, b, side="left"))
        hi = int(np.searchsorted(self.bucket_of, b, side="right"))
        return lo, hi

    def _bucket_rows(self, buckets: np.ndarray) -> np.ndarray:
        """Compacted table rows of ``buckets``, in bucket order."""
        segs = [self.bucket_slice(int(b)) for b in buckets]
        return (np.concatenate([np.arange(lo, hi) for lo, hi in segs])
                if segs else np.empty(0, np.int64))

    def _gather_buckets(self, buckets: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Host float rows of the probed buckets, compacted slices + pending
        appends (the single-query path's view)."""
        if len(buckets) == self.centroids.shape[0]:
            corpus, ids, _ = self._full_corpus()   # exact mode: no copy
            return corpus, ids
        rows = self._bucket_rows(buckets)
        corpus = self.vectors[rows]
        ids = self.ids[rows]
        pend = self._pending.rows(buckets)
        if pend is not None:
            corpus = np.concatenate([corpus, pend.vectors])
            ids = np.concatenate([ids, pend.ids.astype(ids.dtype)])
        return corpus, ids

    def _gather_buckets_dev(self, buckets: np.ndarray
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device float rows of the probed buckets and their int64 ids: an
        ``index_select`` of the resident tables (exact mode: the tables
        themselves), then the pending appends, which are the only rows
        uploaded."""
        if len(buckets) == self.centroids.shape[0]:
            corpus, ids = self.t_vectors, self.t_ids
        else:
            rows = self._upload(self._bucket_rows(buckets), np.int64)
            corpus = torch.index_select(self.t_vectors, 0, rows)
            ids = torch.index_select(self.t_ids, 0, rows)
        pend = self._pending.rows(buckets)
        if pend is not None:
            corpus = torch.cat([corpus, self._upload(pend.vectors)])
            ids = torch.cat([ids, self._upload(pend.ids, np.int64)])
        return corpus, ids

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """ANN search: probe ``nprobe`` nearest buckets, exact scan inside.
        Thin alias of :meth:`search_many`.  One query takes the host path
        (:meth:`_search_one`): at tied scores its answers are the
        reference's one-query answers, which the batched path does not
        give.  Sent through the batched path instead, one query fails the
        two-sided tests whose integer-valued vectors tie: 12 ADC, fused
        and ip search cases and 8 of the 9 pending-row cases."""
        return self.search_many(queries, k, nprobe)

    def search_many(self, queries: np.ndarray, k: int,
                    nprobe: Optional[int] = None, stats=None,
                    mode: str = "auto", rerank: bool = True,
                    rerank_mult: Optional[int] = None, trace=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched two-phase kNN over the whole query set.

        Phase 1: one centroid scoring + top-``nprobe`` for all queries, on
        the device.  Phase 2 picks a batched scan layout:

        * **signature groups** -- queries sharing a probe signature (the
          same bucket set) scan together: their buckets are gathered once on
          the device and dispatched through ``ivf_scan_topk``.  Wins when
          queries cluster (few signatures) and always serves exact mode
          (nprobe=m is one signature).
        * **masked dense scan** (float mode) -- when the signatures are so
          scattered that per-signature gathers would touch at least the
          whole table (#signatures x nprobe >= m), ONE ``ivf_scan_topk``
          of the full corpus with each query's non-probed buckets masked
          to -inf in the scoring kernel (``probe_mask``).
        * **ADC + exact re-rank** (PQ mode) -- per-query score LUTs, an
          ADC top-k' scan of the probed buckets' uint8 codes through
          ``pq_adc_topk`` (k' = ``rerank_mult * k``), then an exact
          re-rank of the k' candidates against the original float
          vectors.  Returned scores are exact.
        * **fused probe->ADC->top-k** (PQ mode) -- ONE masked whole-table
          ADC dispatch for the entire batch, rows of non-probed buckets
          pinned to -inf in-kernel (``probe_mask``).  Requires a compacted
          index; pending appends take the staged ADC path.

        A single-query batch takes a host-side numpy path that skips the
        probe-signature grouping and device dispatch entirely, and breaks
        ties as the reference's one-query path does (:meth:`search`).

        ``mode`` is ``"auto"`` (consult ``stats.choose_knn_scan`` when
        given, else ADC whenever PQ codebooks exist), ``"adc"``,
        ``"float"`` or ``"fused"`` (a hint).  ``rerank=False`` returns raw
        ADC scores/ids truncated to ``k``.  ``rerank_mult`` overrides
        ``cfg.rerank_mult`` for this call.  Positions with no candidate
        hold val=-inf / id=-1.  ``stats``, if given, receives the observed
        scan throughput (cost-model feedback).

        ``trace`` (a :class:`repro_torch.obs.Trace`, optional) receives the
        ``ivf.*`` spans (module docstring); the same spans are profiler
        ranges while the torch profiler records.  ``ivf.search`` carries
        ``q``, ``k``, ``nprobe``, the ``path`` taken (one of
        :data:`PATHS`) and the probe ``signatures`` (None on the fused
        path, which does not group)."""
        if mode not in ("auto", "adc", "float", "fused"):
            raise ValueError(f"unknown scan mode {mode!r}; "
                             f"expected auto | adc | float | fused")
        # the span covers the whole call, so that the card's idle time while
        # this method runs is put down to one of its spans
        with phases(trace, "ivf.search", k=k) as ph:
            queries = np.asarray(queries, np.float32)
            qn = queries.shape[0]
            out_v = np.full((qn, k), -np.inf, np.float32)
            out_i = np.full((qn, k), -1, np.int64)
            if qn == 0 or self.n_total == 0:
                if ph:
                    ph.span.set(q=qn)
                return out_v, out_i
            m = self.centroids.shape[0]
            nprobe = min(nprobe or self.cfg.nprobe, m)
            kind = self._pick_scan(mode, stats, qn, k)
            if qn == 1:
                if ph:
                    ph.next("ivf.search_one")
                path, n_sigs = "one", 1
                t0 = time.perf_counter()
                rows_scanned = self._search_one(
                    queries, k, nprobe, out_v, out_i, kind == "adc", rerank,
                    rerank_mult)
            else:
                if ph:
                    ph.next("ivf.probe")
                q = self._upload(queries)
                cscores = pairwise_scores(q, self.t_centroids,
                                          self.cfg.metric)
                _, probe = stable_topk(cscores, nprobe)        # [Q, nprobe]
                cterm = None
                if self.cfg.pq_residual and kind in ("adc", "fused"):
                    cterm = self._cterm_np(queries, _fetch(cscores))
                # probe *signature* = the bucket set; sort so order never
                # splits groups
                probe = np.sort(_fetch(probe), axis=1)
                t0 = time.perf_counter()
                if kind == "fused":
                    path, n_sigs = "fused", None
                    rows_scanned = self._scan_fused(
                        queries, cterm, probe, k, out_v, out_i, rerank,
                        rerank_mult, ph)
                else:
                    if ph:
                        ph.next("ivf.group")
                    sigs, inverse = _group_signatures(probe)
                    n_sigs = sigs.shape[0]
                    path = ("adc" if kind == "adc" else
                            "dense" if n_sigs > 1 and n_sigs * nprobe >= m
                            else "grouped")
                    if ph:
                        ph.set(signatures=n_sigs, path=path)
                    if path == "adc":
                        rows_scanned = self._scan_groups_pq(
                            queries, sigs, inverse, k, out_v, out_i, rerank,
                            cterm, rerank_mult, ph)
                    elif path == "dense":
                        rows_scanned = self._scan_dense(q, probe, k, out_v,
                                                        out_i, ph)
                    else:
                        rows_scanned = self._scan_groups(q, sigs, inverse, k,
                                                         out_v, out_i, ph)
            self._note_scan(stats, time.perf_counter() - t0, rows_scanned,
                            kind)
            _BATCHES.inc()
            _QUERIES.inc(qn)
            if n_sigs is not None:
                _SIGNATURES.inc(n_sigs)
            _PATH[path].inc()
            if ph:
                ph.span.set(q=qn, nprobe=nprobe, path=path,
                            signatures=n_sigs)
        return out_v, out_i

    def _pick_scan(self, mode: str, stats, qn: int, k: int) -> str:
        """Resolve the scan layout: "float" | "adc" | "fused".  The fused
        hint degrades to staged ADC whenever its preconditions fail (one
        query, pending appends); "auto" asks the cost model."""
        if self.pq is None or self.codes is None or mode == "float":
            return "float"
        if mode == "fused":
            return ("fused" if qn > 1 and self.pending_count == 0
                    else "adc")
        if mode == "adc":
            return "adc"
        if stats is not None:
            return stats.choose_knn_scan(self, q=qn, k=k)
        return "adc"

    def _note_scan(self, stats, dt: float, rows_scanned: int,
                   kind: str) -> None:
        self.scan_rows += rows_scanned
        if stats is not None and rows_scanned:
            if kind == "fused":
                stats.record_fused_scan(dt, rows_scanned)
            elif kind == "adc":
                stats.record_pq_scan(dt, rows_scanned)
            else:
                stats.record_knn_scan(dt, rows_scanned)

    def _norm_queries(self, queries: np.ndarray) -> np.ndarray:
        """Cosine realizes as IP over unit vectors (stored rows are
        normalized at build/insert); l2/ip pass through."""
        if self.cfg.metric != "cosine":
            return queries
        return queries / np.maximum(
            np.linalg.norm(queries, axis=-1, keepdims=True), 1e-9)

    def _kprime(self, k_eff: int, n_real: int, rerank: bool,
                rerank_mult: Optional[int] = None) -> int:
        """ADC candidate fanout: the re-rank stage reads this many rows."""
        if not rerank:
            return k_eff
        rm = self.cfg.rerank_mult if rerank_mult is None else rerank_mult
        return min(n_real, max(k_eff, rm * k_eff))

    def _pq_luts(self, queries: np.ndarray) -> np.ndarray:
        """Score LUTs for the ADC scan.  Residual L2 doubles the IP LUTs:
        the decomposition's query term is ``2 q . r_hat``."""
        luts = self.pq.luts(self._norm_queries(queries))
        if self.cfg.pq_residual and self.cfg.metric == "l2":
            luts = luts * np.float32(2.0)
        return luts

    def _cterm_np(self, queries: np.ndarray, cscores: np.ndarray
                  ) -> np.ndarray:
        """[Q, m] per-query centroid term of the residual decomposition.
        For l2/ip it IS the probe score; cosine probes score against
        *normalized* centroids but the residual sits on the raw centroid,
        so recompute q_hat . c_b here."""
        if self.cfg.metric != "cosine":
            return np.asarray(cscores, np.float32)
        qn_ = self._norm_queries(queries)
        return (qn_ @ self.centroids.T).astype(np.float32)

    def _gather_codes(self, buckets: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 Optional[np.ndarray], Optional[np.ndarray],
                                 Optional[np.ndarray]]:
        """Host ADC view of the probed buckets (the single-query path):
        (codes, ids, comp_rows, pend_stack, row_bucket, bias).  Result
        positions < len(comp_rows) map to compacted table rows
        ``comp_rows[pos]``; later positions map into
        ``pend_stack[pos - len(comp_rows)]``."""
        residual = self.cfg.pq_residual
        if len(buckets) == self.centroids.shape[0]:
            comp_rows = np.arange(len(self.ids))
            codes, ids = self.codes, self.ids
            rb = self.bucket_of if residual else None
            bias = self.code_bias if residual else None
        else:
            comp_rows = self._bucket_rows(buckets)
            codes = self.codes[comp_rows]
            ids = self.ids[comp_rows]
            rb = self.bucket_of[comp_rows] if residual else None
            bias = (self.code_bias[comp_rows] if residual else None)
        pend = self._pending.rows(buckets)
        pend_stack = None
        if pend is not None:
            pend_stack = pend.vectors
            codes = np.concatenate([codes, pend.codes])
            ids = np.concatenate([ids, pend.ids.astype(ids.dtype)])
            if residual:
                rb = np.concatenate(
                    [rb, pend.bucket.astype(self.bucket_of.dtype)])
                bias = np.concatenate([bias, pend.bias])
        return codes, ids, comp_rows, pend_stack, rb, bias

    def _gather_codes_dev(self, buckets: np.ndarray):
        """Device ADC view of the probed buckets: (codes, ids, comp_rows,
        pend_stack, row_bucket int32, bias), the tensors gathered from the
        resident tables with ``index_select`` (exact mode: the tables
        themselves) plus the uploaded pending appends.  Only the uint8
        codes are gathered; re-rank fetches just the k' candidates' float
        rows through :meth:`_fetch_rows`."""
        residual = self.cfg.pq_residual
        if len(buckets) == self.centroids.shape[0]:
            comp_rows = np.arange(len(self.ids))
            codes, ids = self.t_codes, self.ids
            rb = self.t_bucket32 if residual else None
            bias = self.t_bias if residual else None
        else:
            comp_rows = self._bucket_rows(buckets)
            rows = self._upload(comp_rows, np.int64)
            codes = torch.index_select(self.t_codes, 0, rows)
            ids = self.ids[comp_rows]
            rb = (torch.index_select(self.t_bucket32, 0, rows)
                  if residual else None)
            bias = (torch.index_select(self.t_bias, 0, rows)
                    if residual else None)
        pend = self._pending.rows(buckets)
        pend_stack = None
        if pend is not None:
            pend_stack = pend.vectors
            codes = torch.cat([codes, self._upload(pend.codes, np.uint8)])
            ids = np.concatenate([ids, pend.ids.astype(ids.dtype)])
            if residual:
                rb = torch.cat([rb, self._upload(pend.bucket, np.int32)])
                bias = torch.cat([bias, self._upload(pend.bias, np.float32)])
        return codes, ids, comp_rows, pend_stack, rb, bias

    def _fetch_rows(self, comp_rows: np.ndarray,
                    pend_stack: Optional[np.ndarray],
                    idx: np.ndarray) -> np.ndarray:
        """Original float rows of ADC candidates: [..., k'] local positions
        -> [..., k', d] vectors (the re-rank's only float traffic)."""
        nc = len(comp_rows)
        flat = idx.reshape(-1)
        out = np.empty((flat.size, self.vectors.shape[1]), np.float32)
        is_comp = flat < nc
        out[is_comp] = self.vectors[comp_rows[flat[is_comp]]]
        if pend_stack is not None and not is_comp.all():
            out[~is_comp] = pend_stack[flat[~is_comp] - nc]
        return out.reshape(*idx.shape, -1)

    def _search_one(self, queries: np.ndarray, k: int, nprobe: int,
                    out_v: np.ndarray, out_i: np.ndarray,
                    use_adc: bool, rerank: bool,
                    rerank_mult: Optional[int] = None) -> int:
        """Single-query fast path: numpy end-to-end.  One centroid scoring,
        one bucket gather, one scan -- no signature grouping, no device
        round-trip.  Descending score, ties to the lower position in the
        scan set; at ties the ids are the reference's one-query answers,
        which may differ from the batched path's (:meth:`search`)."""
        m = self.centroids.shape[0]
        cscores = _pairwise_scores_np(queries, self.centroids,
                                      self.cfg.metric)[0]
        if nprobe >= m:
            buckets = np.arange(m)
        else:
            buckets = np.sort(np.argpartition(-cscores, nprobe - 1)[:nprobe])
        if use_adc:
            codes, ids, comp_rows, pend_stack, rb, bias = \
                self._gather_codes(buckets)
            n_real = codes.shape[0]
            if n_real == 0:
                return 0
            k_eff = min(k, n_real)
            lut = self._pq_luts(queries)[0]                  # [m, ksub]
            s = lut[np.arange(self.pq.m)[None, :],
                    codes.astype(np.int64)].sum(axis=1)
            if rb is not None:
                cterm = self._cterm_np(queries, cscores[None])[0]
                s = s + bias + cterm[rb.astype(np.int64)]
            kprime = self._kprime(k_eff, n_real, rerank, rerank_mult)
            cand = (np.sort(np.argpartition(-s, kprime - 1)[:kprime])
                    if kprime < n_real else np.arange(n_real))
            if rerank:
                vecs = self._fetch_rows(comp_rows, pend_stack, cand)
                exact = _exact_scores_np(queries, vecs[None],
                                         self.cfg.metric)[0]
                order = _stable_topk_desc(exact, k_eff)
                out_v[0, :k_eff] = exact[order]
            else:
                adc = s[cand]
                order = _stable_topk_desc(adc, k_eff)
                out_v[0, :k_eff] = adc[order]
            out_i[0, :k_eff] = ids[cand[order]]
            return n_real
        corpus, ids = self._gather_buckets(buckets)
        n_real = corpus.shape[0]
        if n_real == 0:
            return 0
        k_eff = min(k, n_real)
        s = _pairwise_scores_np(queries, corpus, self.cfg.metric)[0]
        top = (np.sort(np.argpartition(-s, k_eff - 1)[:k_eff])
               if k_eff < n_real else np.arange(n_real))
        order = top[_stable_topk_desc(s[top], k_eff)]
        out_v[0, :k_eff] = s[order]
        out_i[0, :k_eff] = ids[order]
        return n_real

    def _scan_groups(self, q: torch.Tensor, sigs: np.ndarray,
                     inverse: np.ndarray, k: int,
                     out_v: np.ndarray, out_i: np.ndarray, ph=None) -> int:
        """One gathered kernel scan per distinct probe signature, its
        selected rows mapped to ids on the device.  ``ph``
        (:class:`repro_torch.obs.trace.Phases`, or None) takes each step."""
        rows_scanned = 0
        for g in range(sigs.shape[0]):
            if ph:
                ph.next("ivf.gather")
            qsel = np.nonzero(inverse == g)[0]
            whole = len(qsel) == q.shape[0]
            corpus, ids = self._gather_buckets_dev(sigs[g])
            n_real = corpus.shape[0]
            if ph:
                ph.set(rows=n_real)
            if n_real == 0:
                continue
            qg = q if whole else \
                torch.index_select(q, 0, self._upload(qsel, np.int64))
            k_eff = min(k, n_real)
            if ph:
                ph.next("ivf.scan", rows=n_real, q=len(qsel))
            vals, idx = ivf_scan_topk(qg, corpus, k_eff,
                                      metric=self.cfg.metric)
            found = _map_ids(ids, idx)
            if ph:
                ph.next("ivf.fetch")
            vals, found = _fetch(vals), _fetch(found)
            if ph:
                ph.set(bytes=vals.nbytes + found.nbytes)
                ph.next("ivf.map")
            rows = slice(None) if whole else qsel
            out_v[rows, :k_eff] = vals
            out_i[rows, :k_eff] = found
            rows_scanned += n_real * len(qsel)
        return rows_scanned

    def _scan_groups_pq(self, queries: np.ndarray, sigs: np.ndarray,
                        inverse: np.ndarray, k: int,
                        out_v: np.ndarray, out_i: np.ndarray,
                        rerank: bool, cterm: Optional[np.ndarray] = None,
                        rerank_mult: Optional[int] = None, ph=None) -> int:
        """PQ two-stage scan, one kernel dispatch per distinct probe
        signature: ADC top-k' over the gathered uint8 codes, then exact
        re-rank of the k' candidates against the original float rows.
        ``cterm`` ([Q, m], residual mode) carries each query's centroid
        term; the per-row bias + bucket id ride along from
        :meth:`_gather_codes_dev`."""
        if ph:
            ph.next("ivf.luts")
        luts = self._upload(self._pq_luts(queries))         # [Q, m, ksub]
        cterm_t = None if cterm is None else self._upload(cterm)
        rows_scanned = 0
        for g in range(sigs.shape[0]):
            if ph:
                ph.next("ivf.gather")
            qsel = np.nonzero(inverse == g)[0]
            codes, ids, comp_rows, pend_stack, rb, bias = \
                self._gather_codes_dev(sigs[g])
            n_real = codes.shape[0]
            if ph:
                ph.set(rows=n_real)
            if n_real == 0:
                continue
            qsel_t = self._upload(qsel, np.int64)
            k_eff = min(k, n_real)
            kprime = self._kprime(k_eff, n_real, rerank, rerank_mult)
            if ph:
                ph.next("ivf.scan", rows=n_real, q=len(qsel))
            vals, idx = pq_adc_topk(
                torch.index_select(luts, 0, qsel_t).contiguous(), codes,
                kprime, bias=bias, row_bucket=rb,
                cscores=(None if cterm_t is None else
                         torch.index_select(cterm_t, 0, qsel_t).contiguous()))
            if ph:
                ph.next("ivf.fetch")
            idx = _fetch(idx)                                # [Qg, k']
            vals = None if rerank else _fetch(vals)
            if ph:
                ph.set(bytes=idx.nbytes + (0 if rerank else vals.nbytes))
            idx = idx.astype(np.int64)
            cols = np.arange(k_eff)[None, :]
            if rerank:
                if ph:
                    ph.next("ivf.rerank")
                cand = self._fetch_rows(comp_rows, pend_stack,
                                        idx)                 # [Qg, k', d]
                exact = _exact_scores_np(queries[qsel], cand,
                                         self.cfg.metric)    # [Qg, k']
                order = np.argsort(-exact, axis=1, kind="stable")[:, :k_eff]
                rows = np.arange(len(qsel))[:, None]
                vals, idx = exact[rows, order], idx[rows, order]
            if ph:
                ph.next("ivf.map")
            out_v[qsel[:, None], cols] = vals[:, :k_eff]
            out_i[qsel[:, None], cols] = ids[idx[:, :k_eff]]
            rows_scanned += n_real * len(qsel)
        return rows_scanned

    def _scan_fused(self, queries: np.ndarray, cterm: Optional[np.ndarray],
                    probe: np.ndarray, k: int,
                    out_v: np.ndarray, out_i: np.ndarray,
                    rerank: bool, rerank_mult: Optional[int] = None,
                    ph=None) -> int:
        """Fused probe->ADC->top-k': ONE ``pq_adc_topk`` dispatch over the
        resident code table for the entire batch, each query's non-probed
        buckets pinned to -inf in-kernel via ``probe_mask``.  Precondition
        (held by :meth:`_pick_scan`): the index is compacted, so candidate
        positions ARE table rows.  Candidates, tie order and returned
        scores are identical to the staged ADC path."""
        m = self.centroids.shape[0]
        qn = queries.shape[0]
        n_real = len(self.ids)
        if n_real == 0:
            return 0
        k_eff = min(k, n_real)
        kprime = self._kprime(k_eff, n_real, rerank, rerank_mult)
        residual = cterm is not None
        if ph:
            ph.next("ivf.luts")
        luts = self._upload(self._pq_luts(queries))         # [Q, m, ksub]
        if ph:
            ph.next("ivf.scan", rows=n_real, q=qn)
        pm = np.zeros((qn, m), np.uint8)
        pm[np.arange(qn)[:, None], probe] = 1
        vals, idx = pq_adc_topk(
            luts, self.t_codes, kprime,
            bias=(self.t_bias if residual else None),
            row_bucket=self.t_bucket32,
            cscores=(self._upload(cterm) if residual else None),
            probe_mask=self._upload(pm))
        if ph:
            ph.next("ivf.fetch")
        vals, idx = _fetch(vals), _fetch(idx)                # [Q, k']; -1 pad
        if ph:
            ph.set(bytes=vals.nbytes + idx.nbytes)
        valid = idx >= 0
        safe = np.where(valid, idx, 0).astype(np.int64)
        if rerank:
            if ph:
                ph.next("ivf.rerank")
            rows = np.arange(qn)[:, None]
            cand = self.vectors[safe]                        # [Q, k', d]
            exact = _exact_scores_np(queries, cand, self.cfg.metric)
            exact = np.where(valid, exact, -np.inf)
            order = np.argsort(-exact, axis=1, kind="stable")[:, :k_eff]
            vals, safe = exact[rows, order], safe[rows, order]
        if ph:
            ph.next("ivf.map")
        v = vals[:, :k_eff]
        out_v[:, :k_eff] = v
        out_i[:, :k_eff] = np.where(np.isfinite(v), self.ids[safe[:, :k_eff]],
                                    -1)
        return qn * n_real

    def _scan_dense(self, q: torch.Tensor, probe: np.ndarray, k: int,
                    out_v: np.ndarray, out_i: np.ndarray, ph=None) -> int:
        """One masked scan of the full table for scattered probe batches:
        ``ivf_scan_topk`` over every row, each query's non-probed buckets
        at -inf, the selected rows mapped to ids on the device (positions
        past a query's probed rows map to id -1)."""
        m = self.centroids.shape[0]
        qn = q.shape[0]
        if ph:
            ph.next("ivf.gather")
        corpus, ids = self._gather_buckets_dev(np.arange(m))
        row_bucket = self.t_bucket32
        if self.pending_count:
            _, _, all_buckets = self._full_corpus()
            row_bucket = self._upload(all_buckets, np.int32)
        n_real = corpus.shape[0]
        k_eff = min(k, n_real)
        if ph:
            ph.set(rows=n_real)
            ph.next("ivf.scan", rows=n_real, q=qn)
        probe_mask = np.zeros((qn, m), np.uint8)
        probe_mask[np.arange(qn)[:, None], probe] = 1
        vals, idx = ivf_scan_topk(q, corpus, k_eff, self.cfg.metric,
                                  row_bucket=row_bucket,
                                  probe_mask=self._upload(probe_mask))
        found = torch.where(torch.isfinite(vals), _map_ids(ids, idx), -1)
        if ph:
            ph.next("ivf.fetch")
        vals, found = _fetch(vals), _fetch(found)
        if ph:
            ph.set(bytes=vals.nbytes + found.nbytes)
            ph.next("ivf.map")
        out_v[:, :k_eff] = vals
        out_i[:, :k_eff] = found
        return qn * n_real

    def _full_corpus(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vectors, ids, bucket ids) over compacted + pending rows."""
        pend = self._pending.rows()
        if pend is None:
            return self.vectors, self.ids, self.bucket_of
        return (np.concatenate([self.vectors, pend.vectors]),
                np.concatenate([self.ids, pend.ids.astype(self.ids.dtype)]),
                np.concatenate([self.bucket_of,
                                pend.bucket.astype(self.bucket_of.dtype)]))

    def search_exact(self, queries: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Brute-force ground truth (recall denominator): the batched
        *float* scan with every bucket probed, truncated to the real
        candidate count.  Always float mode -- the truth must not be
        quantized."""
        v, i = self.search_many(queries, k, nprobe=self.centroids.shape[0],
                                mode="float")
        kk = min(k, self.n_total)
        return v[:, :kk], i[:, :kk]

    def retrain_pq(self, stats=None, seed: int = 0) -> None:
        """Re-train the codebooks over the current corpus and re-encode
        every row (codebook drift after sustained dynamic inserts).  Bumps
        the statistics epoch when ``stats`` is given."""
        if self.cfg.pq_m <= 0:
            return
        self.compact()
        train_rows = self.vectors
        if self.cfg.pq_residual:
            train_rows = self.vectors - self.centroids[
                self.bucket_of.astype(np.int64)]
        self.pq = PQCodebook.train(
            train_rows, self.cfg.pq_m, bits=self.cfg.pq_bits,
            iters=self.cfg.pq_kmeans_iters, metric=_pq_metric(self.cfg),
            seed=seed)
        self.codes = self.pq.encode(train_rows)
        if self.cfg.pq_residual:
            self.code_bias = _residual_bias(self.pq, self.codes,
                                            self.centroids, self.bucket_of,
                                            self.cfg.metric)
        self._refresh_device()
        if stats is not None:
            stats.note_index_rebuild("pq_retrain")

    def replica_view(self) -> "IVFIndex":
        """A replica-private view of this index: compacts, then shares the
        (immutable once compacted) arrays and their device tables but owns
        its pending rows, so replicas can absorb DynamicIndexing inserts
        independently.

        A shallow copy, not ``dataclasses.replace``: replace would re-run
        ``__post_init__`` and upload every table to the device once more
        per replica.  Sharing is safe because compaction and retraining
        assign new arrays and tensors instead of writing into the old
        ones."""
        self.compact()
        out = copy.copy(self)
        out._pending = _PendingRows()
        out.scan_rows = 0
        return out

    def shard(self, n_shards: int, strategy: str = "hash",
              assign: Optional[np.ndarray] = None) -> List["IVFIndex"]:
        """Split bucket contents across shards (centroids + codebooks
        replicated, contents sharded), each piece on this index's device.

        ``strategy="hash"`` (default) partitions by :func:`stable_id_hash`
        of the external id; ``strategy="roundrobin"`` keeps the positional
        split; ``assign`` overrides both with an explicit per-row shard
        id."""
        self.compact()
        if assign is not None:
            assign = np.asarray(assign, np.int64)
            if assign.shape[0] != len(self.ids):
                raise ValueError(f"assign has {assign.shape[0]} entries for "
                                 f"{len(self.ids)} rows")
        elif strategy == "hash":
            assign = owner_shard(self.ids, n_shards)
        elif strategy == "roundrobin":
            assign = np.arange(len(self.ids)) % n_shards
        else:
            raise ValueError(f"unknown shard strategy {strategy!r}; "
                             f"expected hash | roundrobin")
        shards = []
        for s in range(n_shards):
            sel = assign == s
            shards.append(IVFIndex(self.cfg, self.centroids,
                                   self.bucket_of[sel], self.vectors[sel],
                                   self.ids[sel], serial=self.serial,
                                   pq=self.pq,
                                   codes=(self.codes[sel]
                                          if self.codes is not None
                                          else None),
                                   code_bias=(self.code_bias[sel]
                                              if self.code_bias is not None
                                              else None),
                                   device=self.device))
        return shards

    @staticmethod
    def merge_pieces(pieces: Sequence["IVFIndex"]) -> "IVFIndex":
        """Reassemble one global index from shard pieces, on the first
        piece's device.  Rows are re-sorted by (bucket, external id), which
        reproduces the batch-build layout exactly."""
        pieces = list(pieces)
        if not pieces:
            raise ValueError("merge_pieces needs at least one piece")
        for p in pieces:
            p.compact()
        base = pieces[0]
        bucket = np.concatenate([p.bucket_of for p in pieces])
        vecs = np.concatenate([p.vectors for p in pieces])
        ids = np.concatenate([p.ids for p in pieces])
        codes = (np.concatenate([p.codes for p in pieces])
                 if base.codes is not None else None)
        bias = (np.concatenate([p.code_bias for p in pieces])
                if base.code_bias is not None else None)
        order = np.lexsort((ids, bucket))
        return IVFIndex(base.cfg, base.centroids, bucket[order], vecs[order],
                        ids[order], serial=base.serial, pq=base.pq,
                        codes=(codes[order] if codes is not None else None),
                        code_bias=(bias[order] if bias is not None else None),
                        device=base.device)


def _exact_scores_np(queries: np.ndarray, cand: np.ndarray, metric: str
                     ) -> np.ndarray:
    """Re-rank scoring: [Q, d] x [Q, k', d] -> [Q, k'], higher is better."""
    queries = np.asarray(queries, np.float32)
    cand = np.asarray(cand, np.float32)
    if metric == "ip":
        return np.einsum("qd,qkd->qk", queries, cand, dtype=np.float32)
    if metric == "cosine":
        qn = queries / np.maximum(
            np.linalg.norm(queries, axis=-1, keepdims=True), 1e-9)
        cn = cand / np.maximum(
            np.linalg.norm(cand, axis=-1, keepdims=True), 1e-9)
        return np.einsum("qd,qkd->qk", qn, cn, dtype=np.float32)
    diff = cand - queries[:, None, :]
    return -np.sum(diff * diff, axis=-1)


def _stable_topk_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest scores, ties to the lower index (the
    ``lax.top_k`` order the batched paths produce)."""
    return np.argsort(-scores, kind="stable")[:k]


def recall_at_k(index: IVFIndex, queries: np.ndarray, k: int,
                nprobe: Optional[int] = None,
                rerank: bool = True) -> float:
    _, approx = index.search_many(queries, k, nprobe, rerank=rerank)
    _, exact = index.search_exact(queries, k)
    hits = 0
    for a, e in zip(approx, exact):
        hits += len(set(a.tolist()) & set(e.tolist()) - {-1})
    return hits / (queries.shape[0] * k)
