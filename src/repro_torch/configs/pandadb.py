"""PandaDB deployment config: the paper's own system knobs (§IV-§VI)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class VectorIndexConfig:
    """IVF-Flat per Algorithm 2: ~1 bucket per `vectors_per_bucket` vectors."""

    dim: int = 128
    metric: str = "l2"            # l2 | ip | cosine
    vectors_per_bucket: int = 100_000   # paper's empirical value
    min_buckets: int = 4
    nprobe: int = 8               # buckets scanned per query
    kmeans_iters: int = 8         # batch-build refinement steps
    pending_compact_frac: float = 0.1   # compact append buffers once pending
    #                                     rows exceed this fraction of N
    pending_compact_min: int = 1024     # ... but never before this many
    # -- product quantization (IVF-PQ mode) --
    pq_m: int = 0                 # subspaces per vector; 0 = IVF-Flat (no PQ).
    #                               dim % pq_m must be 0 when enabled
    pq_bits: int = 8              # bits per code -> K = 2**bits centers per
    #                               subspace (8 keeps the ADC kernel MXU-wide)
    pq_kmeans_iters: int = 6      # per-subspace codebook refinement steps
    rerank_mult: int = 8          # ADC candidate fanout: scan keeps k' =
    #                               rerank_mult * k codes, exact re-rank
    #                               against original vectors returns top-k
    #                               (recall@10 >= 0.95 on clustered corpora)
    pq_residual: bool = False     # quantize vector - centroid[bucket] instead
    #                               of the raw vector: residuals are smaller
    #                               and better centered, so the same codebook
    #                               budget yields tighter ADC ordering (and a
    #                               smaller rerank_mult holds recall).  Scores
    #                               decompose as LUT sum + per-row bias +
    #                               per-query centroid term (see pq_scan/ref)


@dataclass(frozen=True)
class BlobStoreConfig:
    """BLOB metadata/content separation (§VI-A, Fig 5)."""

    inline_threshold: int = 10 * 1024  # <10kB stored inline as long-string
    table_columns: int = 64            # BLOB-table columns (row=id/|col|, col=id%|col|)
    metadata_bytes: int = 29           # length + mime + id (paper: "28.5 bytes")


@dataclass(frozen=True)
class CacheConfig:
    """Semantic-information cache keyed by (item, subprop, model serial)."""

    capacity_items: int = 1_000_000
    eviction: str = "lru"


@dataclass(frozen=True)
class AIPMConfig:
    """AI-model interactive protocol: async batched extractor dispatch."""

    max_batch: int = 256
    max_inflight: int = 4          # bounded async queue depth (backpressure)
    timeout_ms: int = 30_000
    workers: int = 2               # model-service parallelism (φ batches in flight)
    prefetch_depth: int = 2        # chunks of φ work submitted ahead of the
    #                                semantic filter's consumption point; 0 = sync
    auto_batch: bool = True        # size φ slices from observed avg_speed
    target_batch_s: float = 0.05   # auto_batch aims one slice ≈ this long


@dataclass(frozen=True)
class CostModelConfig:
    """Operator-speed statistics (§V-B): EWMA over observed per-row times."""

    ewma_alpha: float = 0.3
    default_structured_speed: float = 1e-7   # s/row prior
    default_semantic_speed: float = 0.3      # s/row prior (paper: 0.3s/face)
    default_knn_scan_speed: float = 2e-9     # s per corpus row scanned (prior;
    #                                          replaced by observed throughput)
    default_pq_scan_speed: float = 5e-10     # s per code row ADC-scanned
    #                                          (prior; the uint8 scan is
    #                                          bandwidth-bound, ~4-8x the
    #                                          float throughput)
    default_fused_scan_speed: float = 5e-10  # s per code row of the fused
    #                                          probe->ADC->top-k scan (prior
    #                                          only: choose_knn_scan never
    #                                          picks fused before observing
    #                                          a real measurement)
    shard_dispatch_s: float = 1e-4           # fixed cost of scattering one
    #                                          statement/scan to one shard
    #                                          (ctx setup + queueing); the
    #                                          fan-out term routed plans
    #                                          avoid
    # -- replica sets (§VII-A replication) --
    default_replica_read_s: float = 5e-3     # per-read latency prior until a
    #                                          replica has been measured
    hedge_quantile: float = 0.5              # latency quantile the hedge
    #                                          deadline is derived from (the
    #                                          median stays honest even when
    #                                          a minority of reads are
    #                                          fault-slowed; p9x would learn
    #                                          the outliers it should mask)
    hedge_deadline_mult: float = 3.0         # deadline = quantile * mult
    hedge_floor_s: float = 5e-3              # minimum deadline (cold start /
    #                                          very fast shards: don't hedge
    #                                          on scheduler noise)
    # -- proxy-first φ cascades (ROADMAP item 3) --
    default_proxy_scan_speed: float = 1e-5   # s/row prior for the cheap proxy
    #                                          scorer (replaced by observed
    #                                          throughput via record_proxy_scan)
    default_escalation_frac: float = 0.35    # fraction of rows expected to
    #                                          fall in [lo, hi] and escalate to
    #                                          the exact φ before any cascade
    #                                          has been observed
    # -- deadline-driven degradation ladder --
    accuracy_relax_notch: float = 0.05       # one ladder step lowers a
    #                                          cascade's WITH ACCURACY target
    #                                          by this much (never below
    #                                          accuracy_relax_floor)
    accuracy_relax_floor: float = 0.5


@dataclass(frozen=True)
class ClusterConfig:
    """Sharded serving (§VII-A): property + unstructured data partitioned
    by stable node-id hash, graph structure + index metadata replicated."""

    n_shards: int = 1
    parallel_fanout: bool = True   # scatter shard scans on a thread pool
    #                                (results are merged in shard order, so
    #                                output is deterministic either way)
    merge_batch_rows: int = 256    # coordinator's ordered-merge chunk size
    # -- self-healing replication (ReplicatedPandaDB) --
    replication: int = 1           # replicas per shard (1 = no replica sets)
    hedge_reads: bool = True       # race a second replica once a read leg
    #                                misses the latency-quantile deadline
    #                                (first responder wins, loser closed)
    read_retries: int = 2          # transient-error retries per read leg
    #                                before failing over to another replica
    retry_backoff_s: float = 0.002  # linear backoff between retries
    split_rerank_budget: bool = False  # divide the global re-rank candidate
    #                                budget ceil(rerank_mult/P) per shard so
    #                                total exact-re-rank work stays constant
    #                                as P grows (pair with pq_residual=True:
    #                                tighter ADC ordering keeps the smaller
    #                                per-shard pools exact in practice)
    rebalance_skew: float = 2.0    # max/mean owned-rows ratio above which
    #                                the Rebalancer proposes moves
    # -- end-to-end deadlines --
    default_deadline_ms: int = 0   # per-query budget applied when run() names
    #                                none; 0 = queries have no deadline
    close_drain_s: float = 2.0     # close() budget for draining in-flight
    #                                hedge legs (was a hard-coded wait(2.0))
    # -- per-replica circuit breakers --
    breaker_failures: int = 2      # consecutive failures (or slow calls) that
    #                                flip a replica's breaker open; <= read
    #                                retries so a flapping replica fails over
    #                                inside one statement's retry budget
    breaker_reset_s: float = 0.25  # open -> half-open cool-down before one
    #                                timed probe is allowed through
    breaker_slow_call_s: float = 0.0   # reads slower than this count as
    #                                failures (0 = slow-call tracking off)


@dataclass(frozen=True)
class CascadeConfig:
    """Proxy-first φ cascades: accuracy-targeted semantic predicates."""

    calibration_sample: int = 128   # blobs sampled for threshold fitting
    calibration_pairs: int = 1024   # (i, j) score/label pairs drawn from them
    calibration_seed: int = 0       # deterministic sampling (shard parity)
    min_curve_pairs: int = 16       # below this the calibrator refuses to fit
    #                                 (escalate everything instead of guessing)


@dataclass(frozen=True)
class ServingConfig:
    """QueryServer admission control: shed early, degrade gracefully,
    never let an unbounded queue turn overload into collapse."""

    queue_depth: int = 0            # bounded request queue; 0 = unbounded
    #                                 (the seed's behavior)
    admission_policy: str = "reject"   # queue-full policy: "reject" bounces
    #                                 the new request, "drop_oldest" evicts
    #                                 the request that has waited longest
    #                                 (it is the most likely to be expired)
    default_deadline_ms: int = 0    # budget stamped on requests that name
    #                                 none at submit(); 0 = no deadline
    shed_on_arrival: bool = True    # refuse requests whose estimated queue
    #                                 wait + service time already exceeds
    #                                 their remaining budget (only requests
    #                                 carrying a deadline are ever shed)


@dataclass(frozen=True)
class ObsConfig:
    """Observability: query tracing, metrics export, slow-query log."""

    trace: bool = False             # per-query span trees; OFF by default —
    #                                 disabled tracing must cost near-zero
    #                                 (gated by bench_obs_overhead.py)
    trace_keep_last: bool = True    # tracer keeps the most recent Trace for
    #                                 inspection (tracer.last)
    slow_query_ms: float = 0.0      # serving engine writes a JSON line for
    #                                 queries slower than this; 0 = off
    slow_query_log: str = ""        # path of the JSON-lines slow-query log
    #                                 ("" with slow_query_ms > 0 = stderr)


@dataclass(frozen=True)
class PandaDBConfig:
    index: VectorIndexConfig = field(default_factory=VectorIndexConfig)
    blob: BlobStoreConfig = field(default_factory=BlobStoreConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    aipm: AIPMConfig = field(default_factory=AIPMConfig)
    cost: CostModelConfig = field(default_factory=CostModelConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    # distributed layout (§VII-A): structure replicated, properties sharded
    replicate_graph_structure: bool = True
    shard_axis: str = "data"


DEFAULT = PandaDBConfig()
