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
compacted ``vectors``, ``codes``, ``bucket_of``, ``code_bias`` and the
centroids are kept resident there and refreshed after ``build``,
``compact``, ``insert_many`` and ``retrain_pq``; each scan gathers its
buckets with ``index_select`` on the device instead of uploading the table.
Numpy mirrors of the same arrays serve the host bookkeeping, the exact
re-rank and the single-query host path.

IVF-PQ (``cfg.pq_m > 0``): :class:`PQCodebook` trains per-subspace k-means
codebooks at build time and every bucket stores uint8 codes (M bytes per
row instead of 4*dim).  Search is two-stage: per-query score LUTs + an
asymmetric-distance (ADC) top-k' scan of the probed buckets through
``kernels.pq_scan.ops.pq_adc_topk``, then an exact re-rank of the k'
candidates against the original float vectors that returns true top-k
scores.  The cost model picks ADC vs float scan per query batch from
observed throughputs (``StatisticsService.choose_knn_scan``).

The cluster layer of the reference (``scatter_gather_knn``,
``flat_shard_view``, ``distributed_knn``, ``merge_topk``) comes with the
port's cluster slice; :meth:`IVFIndex.shard` and
:meth:`IVFIndex.merge_pieces` are here already.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.pandadb import VectorIndexConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk
from repro_torch.kernels.pq_scan.ops import pq_adc_topk
from repro_torch.kernels.topk import stable_topk


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


def masked_scan_topk(q: torch.Tensor, corpus: torch.Tensor,
                     row_bucket: torch.Tensor, probe_mask: torch.Tensor,
                     k: int, metric: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense probe scan: ONE [Q, N] score product with each query's
    non-probed buckets masked to -inf before the top-k.

    ``row_bucket[N]`` is each corpus row's bucket id, ``probe_mask[Q, m]``
    is True at the buckets a query probes.  Scans the whole table, so it
    only wins when the batch's probe signatures are scattered enough that
    per-signature gathers would touch >= the table anyway --
    ``IVFIndex.search_many`` makes that call."""
    s = pairwise_scores(q, corpus, metric)              # [Q, N]
    s = torch.where(probe_mask[:, row_bucket], s, -torch.inf)
    return stable_topk(s, k)


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
    # dynamic-insert append buffers (bucket -> uncompacted rows); searches
    # always include these, compaction folds them into the sorted layout
    _pend_vecs: Dict[int, List[np.ndarray]] = dataclasses.field(
        default_factory=dict, repr=False)
    _pend_ids: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict, repr=False)
    _pend_codes: Dict[int, List[np.ndarray]] = dataclasses.field(
        default_factory=dict, repr=False)
    _pend_bias: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict, repr=False)
    pending_count: int = 0
    # observed scan throughput (feeds the cost model's kNN term)
    scan_rows: int = 0
    scan_time: float = 0.0
    # where the scan-resident tables live (None: the CUDA card)
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self._refresh_device()

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(self.device)

    def _refresh_device(self) -> None:
        """Upload the compacted tables: the scans read only these."""
        self.vectors = np.ascontiguousarray(self.vectors, np.float32)
        self.t_centroids = self._to_device(np.asarray(self.centroids,
                                                      np.float32))
        self.t_vectors = self._to_device(self.vectors)
        self.t_bucket = self._to_device(np.asarray(self.bucket_of), np.int64)
        self.t_bucket32 = self.t_bucket.to(torch.int32)
        self.t_codes = (None if self.codes is None
                        else self._to_device(np.asarray(self.codes),
                                             np.uint8))
        self.t_bias = (None if self.code_bias is None
                       else self._to_device(np.asarray(self.code_bias),
                                            np.float32))

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
            pend = sum(len(v) for v in self._pend_codes.values()) * self.pq.m
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
        if self.pending_count:
            pb, pv, pi, pc, ps = [], [], [], [], []
            for b in sorted(self._pend_vecs):
                pb += [b] * len(self._pend_vecs[b])
                pv += self._pend_vecs[b]
                pi += self._pend_ids[b]
                pc += self._pend_codes.get(b, [])
                ps += self._pend_bias.get(b, [])
            state["pend_bucket"] = np.asarray(pb, np.int64)
            state["pend_vectors"] = np.stack(pv).astype(np.float32)
            state["pend_ids"] = np.asarray(pi, np.int64)
            if pc:
                state["pend_codes"] = np.stack(pc).astype(np.uint8)
            if ps:
                state["pend_bias"] = np.asarray(ps, np.float32)
        return state

    @staticmethod
    def from_state(state: Dict[str, np.ndarray],
                   cfg: VectorIndexConfig, device: DeviceLike = None,
                   serial: int = 1) -> "IVFIndex":
        """An index over exactly the given arrays (the keys of
        :meth:`to_state`); pending rows (``pend_*``) join their buckets'
        append buffers in the order given."""
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
        pb = state.get("pend_bucket")
        if pb is not None:
            for i, b in enumerate(np.asarray(pb).tolist()):
                index._pend_vecs.setdefault(b, []).append(
                    np.asarray(state["pend_vectors"][i], np.float32))
                index._pend_ids.setdefault(b, []).append(
                    int(state["pend_ids"][i]))
                if "pend_codes" in state:
                    index._pend_codes.setdefault(b, []).append(
                        np.asarray(state["pend_codes"][i], np.uint8))
                if "pend_bias" in state:
                    index._pend_bias.setdefault(b, []).append(
                        float(state["pend_bias"][i]))
            index.pending_count = len(pb)
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
        self._pend_vecs.setdefault(b, []).append(vec)
        self._pend_ids.setdefault(b, []).append(int(ext_id))
        if self.pq is not None:
            enc = vec[None]
            if self.cfg.pq_residual:
                enc = enc - self.centroids[b][None]
            code = self.pq.encode(enc)[0]
            self._pend_codes.setdefault(b, []).append(code)
            if self.cfg.pq_residual:
                self._pend_bias.setdefault(b, []).append(float(
                    _residual_bias(self.pq, code[None], self.centroids,
                                   np.asarray([b]), self.cfg.metric)[0]))
        self.pending_count += 1
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
        for i, (v, b, eid) in enumerate(zip(vecs, assign,
                                            np.asarray(ext_ids))):
            b = int(b)
            self._pend_vecs.setdefault(b, []).append(v)
            self._pend_ids.setdefault(b, []).append(int(eid))
            if codes is not None:
                self._pend_codes.setdefault(b, []).append(codes[i])
            if bias is not None:
                self._pend_bias.setdefault(b, []).append(float(bias[i]))
        self.pending_count += len(vecs)
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
        if not self.pending_count:
            return
        add_b: List[int] = []
        add_v: List[np.ndarray] = []
        add_i: List[int] = []
        add_c: List[np.ndarray] = []
        add_s: List[float] = []
        for b in sorted(self._pend_vecs):
            add_b += [b] * len(self._pend_vecs[b])
            add_v += self._pend_vecs[b]
            add_i += self._pend_ids[b]
            if self.pq is not None:
                add_c += self._pend_codes.get(b, [])
                add_s += self._pend_bias.get(b, [])
        bucket_of = np.concatenate(
            [self.bucket_of, np.asarray(add_b, self.bucket_of.dtype)])
        order = np.argsort(bucket_of, kind="stable")
        self.bucket_of = bucket_of[order]
        self.vectors = np.concatenate(
            [self.vectors, np.stack(add_v)])[order]
        self.ids = np.concatenate(
            [self.ids, np.asarray(add_i, self.ids.dtype)])[order]
        if self.pq is not None and self.codes is not None:
            self.codes = np.concatenate(
                [self.codes, np.stack(add_c)])[order]
        if self.code_bias is not None:
            self.code_bias = np.concatenate(
                [self.code_bias, np.asarray(add_s, np.float32)])[order]
        self._pend_vecs.clear()
        self._pend_ids.clear()
        self._pend_codes.clear()
        self._pend_bias.clear()
        self.pending_count = 0
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

    def _pending_of(self, buckets) -> Tuple[List[np.ndarray], List[int]]:
        pend_v: List[np.ndarray] = []
        pend_i: List[int] = []
        for b in buckets:
            b = int(b)
            if b in self._pend_vecs:
                pend_v += self._pend_vecs[b]
                pend_i += self._pend_ids[b]
        return pend_v, pend_i

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
        pend_v, pend_i = self._pending_of(buckets)
        if pend_v:
            corpus = np.concatenate([corpus, np.stack(pend_v)])
            ids = np.concatenate([ids, np.asarray(pend_i, ids.dtype)])
        return corpus, ids

    def _gather_buckets_dev(self, buckets: np.ndarray
                            ) -> Tuple[torch.Tensor, np.ndarray]:
        """Device float rows of the probed buckets: an ``index_select`` of
        the resident table (exact mode: the table itself), then the pending
        appends, which are the only rows uploaded."""
        if len(buckets) == self.centroids.shape[0]:
            corpus, ids = self.t_vectors, self.ids
            pend_v, pend_i = self._pending_of(sorted(self._pend_vecs))
        else:
            rows = self._bucket_rows(buckets)
            corpus = torch.index_select(self.t_vectors, 0,
                                        self._to_device(rows, np.int64))
            ids = self.ids[rows]
            pend_v, pend_i = self._pending_of(buckets)
        if pend_v:
            corpus = torch.cat([corpus, self._to_device(np.stack(pend_v))])
            ids = np.concatenate([ids, np.asarray(pend_i, ids.dtype)])
        return corpus, ids

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """ANN search: probe ``nprobe`` nearest buckets, exact scan inside.
        Thin alias of :meth:`search_many` (the batched path is the only
        path)."""
        return self.search_many(queries, k, nprobe)

    def search_many(self, queries: np.ndarray, k: int,
                    nprobe: Optional[int] = None, stats=None,
                    mode: str = "auto", rerank: bool = True,
                    rerank_mult: Optional[int] = None
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
          whole table (#signatures x nprobe >= m), ONE scan of the full
          corpus with each query's non-probed buckets masked to -inf
          (:func:`masked_scan_topk`).
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
        probe-signature grouping and device dispatch entirely.

        ``mode`` is ``"auto"`` (consult ``stats.choose_knn_scan`` when
        given, else ADC whenever PQ codebooks exist), ``"adc"``,
        ``"float"`` or ``"fused"`` (a hint).  ``rerank=False`` returns raw
        ADC scores/ids truncated to ``k``.  ``rerank_mult`` overrides
        ``cfg.rerank_mult`` for this call.  Positions with no candidate
        hold val=-inf / id=-1.  ``stats``, if given, receives the observed
        scan throughput (cost-model feedback)."""
        if mode not in ("auto", "adc", "float", "fused"):
            raise ValueError(f"unknown scan mode {mode!r}; "
                             f"expected auto | adc | float | fused")
        queries = np.asarray(queries, np.float32)
        qn = queries.shape[0]
        out_v = np.full((qn, k), -np.inf, np.float32)
        out_i = np.full((qn, k), -1, np.int64)
        if qn == 0 or self.n_total == 0:
            return out_v, out_i
        m = self.centroids.shape[0]
        nprobe = min(nprobe or self.cfg.nprobe, m)
        kind = self._pick_scan(mode, stats, qn, k)
        if qn == 1:
            t0 = time.perf_counter()
            rows_scanned = self._search_one(queries, k, nprobe, out_v, out_i,
                                            kind == "adc", rerank,
                                            rerank_mult)
            self._note_scan(stats, time.perf_counter() - t0, rows_scanned,
                            kind)
            return out_v, out_i
        q = self._to_device(queries)
        cscores = pairwise_scores(q, self.t_centroids, self.cfg.metric)
        _, probe = stable_topk(cscores, nprobe)                # [Q, nprobe]
        cterm = None
        if self.cfg.pq_residual and kind in ("adc", "fused"):
            cterm = self._cterm_np(queries, cscores.cpu().numpy())
        # probe *signature* = the bucket set; sort so order never splits groups
        probe = np.sort(probe.cpu().numpy(), axis=1)
        t0 = time.perf_counter()
        if kind == "fused":
            rows_scanned = self._scan_fused(queries, cterm, probe, k,
                                            out_v, out_i, rerank,
                                            rerank_mult)
        else:
            sigs, inverse = np.unique(probe, axis=0, return_inverse=True)
            inverse = inverse.reshape(-1)
            if kind == "adc":
                rows_scanned = self._scan_groups_pq(queries, sigs, inverse,
                                                    k, out_v, out_i, rerank,
                                                    cterm, rerank_mult)
            elif sigs.shape[0] > 1 and sigs.shape[0] * nprobe >= m:
                rows_scanned = self._scan_dense(q, probe, k, out_v, out_i)
            else:
                rows_scanned = self._scan_groups(q, sigs, inverse, k,
                                                 out_v, out_i)
        self._note_scan(stats, time.perf_counter() - t0, rows_scanned,
                        kind)
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
        self.scan_time += dt
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
            pend_sel = sorted(self._pend_vecs)
            codes, ids = self.codes, self.ids
            rb = self.bucket_of if residual else None
            bias = self.code_bias if residual else None
        else:
            comp_rows = self._bucket_rows(buckets)
            pend_sel = [int(b) for b in buckets if int(b) in self._pend_vecs]
            codes = self.codes[comp_rows]
            ids = self.ids[comp_rows]
            rb = self.bucket_of[comp_rows] if residual else None
            bias = (self.code_bias[comp_rows] if residual else None)
        pend = self._pending_codes(pend_sel)
        pend_stack = None
        if pend is not None:
            pend_stack, pc, pi, pb, ps = pend
            codes = np.concatenate([codes, pc])
            ids = np.concatenate([ids, np.asarray(pi, ids.dtype)])
            if residual:
                rb = np.concatenate([rb, pb])
                bias = np.concatenate([bias, ps])
        return codes, ids, comp_rows, pend_stack, rb, bias

    def _pending_codes(self, pend_sel: Sequence[int]):
        """Pending appends of ``pend_sel`` buckets as stacked arrays:
        (vectors, codes, ids, buckets, biases), or None when there are
        none."""
        pend_v: List[np.ndarray] = []
        pend_i: List[int] = []
        pend_c: List[np.ndarray] = []
        pend_s: List[float] = []
        pend_b: List[int] = []
        for b in pend_sel:
            pend_v += self._pend_vecs[b]
            pend_i += self._pend_ids[b]
            pend_c += self._pend_codes.get(b, [])
            pend_s += self._pend_bias.get(b, [])
            pend_b += [b] * len(self._pend_vecs[b])
        if not pend_v:
            return None
        return (np.stack(pend_v), np.stack(pend_c), pend_i,
                np.asarray(pend_b, self.bucket_of.dtype),
                np.asarray(pend_s, np.float32))

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
            pend_sel = sorted(self._pend_vecs)
            codes, ids = self.t_codes, self.ids
            rb = self.t_bucket32 if residual else None
            bias = self.t_bias if residual else None
        else:
            comp_rows = self._bucket_rows(buckets)
            pend_sel = [int(b) for b in buckets if int(b) in self._pend_vecs]
            rows = self._to_device(comp_rows, np.int64)
            codes = torch.index_select(self.t_codes, 0, rows)
            ids = self.ids[comp_rows]
            rb = (torch.index_select(self.t_bucket32, 0, rows)
                  if residual else None)
            bias = (torch.index_select(self.t_bias, 0, rows)
                    if residual else None)
        pend = self._pending_codes(pend_sel)
        pend_stack = None
        if pend is not None:
            pend_stack, pc, pi, pb, ps = pend
            codes = torch.cat([codes, self._to_device(pc, np.uint8)])
            ids = np.concatenate([ids, np.asarray(pi, ids.dtype)])
            if residual:
                rb = torch.cat([rb, self._to_device(pb, np.int32)])
                bias = torch.cat([bias, self._to_device(ps, np.float32)])
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
        round-trip.  Candidate order matches the batched path (descending
        score, ties to the lower row index)."""
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
                     out_v: np.ndarray, out_i: np.ndarray) -> int:
        """One gathered kernel scan per distinct probe signature."""
        rows_scanned = 0
        for g in range(sigs.shape[0]):
            qsel = np.nonzero(inverse == g)[0]
            corpus, ids = self._gather_buckets_dev(sigs[g])
            n_real = corpus.shape[0]
            if n_real == 0:
                continue
            k_eff = min(k, n_real)
            qg = q if len(qsel) == q.shape[0] else \
                torch.index_select(q, 0, self._to_device(qsel, np.int64))
            vals, idx = ivf_scan_topk(qg, corpus, k_eff,
                                      metric=self.cfg.metric)
            cols = np.arange(k_eff)[None, :]
            out_v[qsel[:, None], cols] = vals.cpu().numpy()
            out_i[qsel[:, None], cols] = ids[idx.cpu().numpy()]
            rows_scanned += n_real * len(qsel)
        return rows_scanned

    def _scan_groups_pq(self, queries: np.ndarray, sigs: np.ndarray,
                        inverse: np.ndarray, k: int,
                        out_v: np.ndarray, out_i: np.ndarray,
                        rerank: bool, cterm: Optional[np.ndarray] = None,
                        rerank_mult: Optional[int] = None) -> int:
        """PQ two-stage scan, one kernel dispatch per distinct probe
        signature: ADC top-k' over the gathered uint8 codes, then exact
        re-rank of the k' candidates against the original float rows.
        ``cterm`` ([Q, m], residual mode) carries each query's centroid
        term; the per-row bias + bucket id ride along from
        :meth:`_gather_codes_dev`."""
        luts = self._to_device(self._pq_luts(queries))      # [Q, m, ksub]
        cterm_t = None if cterm is None else self._to_device(cterm)
        rows_scanned = 0
        for g in range(sigs.shape[0]):
            qsel = np.nonzero(inverse == g)[0]
            codes, ids, comp_rows, pend_stack, rb, bias = \
                self._gather_codes_dev(sigs[g])
            n_real = codes.shape[0]
            if n_real == 0:
                continue
            k_eff = min(k, n_real)
            kprime = self._kprime(k_eff, n_real, rerank, rerank_mult)
            qsel_t = self._to_device(qsel, np.int64)
            vals, idx = pq_adc_topk(
                torch.index_select(luts, 0, qsel_t).contiguous(), codes,
                kprime, bias=bias, row_bucket=rb,
                cscores=(None if cterm_t is None else
                         torch.index_select(cterm_t, 0, qsel_t).contiguous()))
            idx = idx.cpu().numpy().astype(np.int64)         # [Qg, k']
            cols = np.arange(k_eff)[None, :]
            if rerank:
                cand = self._fetch_rows(comp_rows, pend_stack,
                                        idx)                 # [Qg, k', d]
                exact = _exact_scores_np(queries[qsel], cand,
                                         self.cfg.metric)    # [Qg, k']
                order = np.argsort(-exact, axis=1, kind="stable")[:, :k_eff]
                rows = np.arange(len(qsel))[:, None]
                out_v[qsel[:, None], cols] = exact[rows, order]
                out_i[qsel[:, None], cols] = ids[idx[rows, order]]
            else:
                out_v[qsel[:, None], cols] = vals.cpu().numpy()[:, :k_eff]
                out_i[qsel[:, None], cols] = ids[idx[:, :k_eff]]
            rows_scanned += n_real * len(qsel)
        return rows_scanned

    def _scan_fused(self, queries: np.ndarray, cterm: Optional[np.ndarray],
                    probe: np.ndarray, k: int,
                    out_v: np.ndarray, out_i: np.ndarray,
                    rerank: bool, rerank_mult: Optional[int] = None) -> int:
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
        pm = np.zeros((qn, m), np.uint8)
        pm[np.arange(qn)[:, None], probe] = 1
        luts = self._to_device(self._pq_luts(queries))      # [Q, m, ksub]
        residual = cterm is not None
        vals, idx = pq_adc_topk(
            luts, self.t_codes, kprime,
            bias=(self.t_bias if residual else None),
            row_bucket=self.t_bucket32,
            cscores=(self._to_device(cterm) if residual else None),
            probe_mask=self._to_device(pm))
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy().astype(np.int64)             # [Q, k']; -1 pad
        valid = idx >= 0
        safe = np.where(valid, idx, 0)
        rows = np.arange(qn)[:, None]
        if rerank:
            cand = self.vectors[safe]                        # [Q, k', d]
            exact = _exact_scores_np(queries, cand, self.cfg.metric)
            exact = np.where(valid, exact, -np.inf)
            order = np.argsort(-exact, axis=1, kind="stable")[:, :k_eff]
            v = exact[rows, order]
            gid = self.ids[safe][rows, order]
        else:
            v = vals[:, :k_eff]
            gid = self.ids[safe[:, :k_eff]]
        out_v[:, :k_eff] = v
        out_i[:, :k_eff] = np.where(np.isfinite(v), gid, -1)
        return qn * n_real

    def _scan_dense(self, q: torch.Tensor, probe: np.ndarray, k: int,
                    out_v: np.ndarray, out_i: np.ndarray) -> int:
        """One masked scan of the full table for scattered probe batches."""
        m = self.centroids.shape[0]
        qn = q.shape[0]
        corpus, ids = self._gather_buckets_dev(np.arange(m))
        row_bucket = self.t_bucket
        if self.pending_count:
            _, _, all_buckets = self._full_corpus()
            row_bucket = self._to_device(all_buckets, np.int64)
        n_real = corpus.shape[0]
        probe_mask = np.zeros((qn, m), bool)
        probe_mask[np.arange(qn)[:, None], probe] = True
        k_eff = min(k, n_real)
        vals, idx = masked_scan_topk(q, corpus, row_bucket,
                                     self._to_device(probe_mask), k_eff,
                                     self.cfg.metric)
        vals = vals.cpu().numpy()
        gids = ids[idx.cpu().numpy()]
        out_v[:, :k_eff] = vals
        out_i[:, :k_eff] = np.where(np.isfinite(vals), gids, -1)
        return qn * n_real

    def _full_corpus(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(vectors, ids, bucket ids) over compacted + pending rows."""
        if not self.pending_count:
            return self.vectors, self.ids, self.bucket_of
        pend_v: List[np.ndarray] = []
        pend_i: List[int] = []
        pend_b: List[int] = []
        for b in sorted(self._pend_vecs):
            pend_v += self._pend_vecs[b]
            pend_i += self._pend_ids[b]
            pend_b += [b] * len(self._pend_vecs[b])
        return (np.concatenate([self.vectors, np.stack(pend_v)]),
                np.concatenate([self.ids, np.asarray(pend_i, self.ids.dtype)]),
                np.concatenate([self.bucket_of,
                                np.asarray(pend_b, self.bucket_of.dtype)]))

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
