"""Sharded cluster subsystem (paper §VII-A): hash-partitioned shards,
replica sets with hedged/failover reads, scatter-gather + routed query
serving, and live rebalancing."""
from repro_torch.cluster.coordinator import (
    ClusterCursor,
    ClusterPreparedStatement,
    ClusterSession,
    ShardedPandaDB,
)
from repro_torch.cluster.partition import (
    TEMP_BLOB_BASE,
    ShardMap,
    default_owner_fn,
    make_shard,
    owner_shard,
    stable_id_hash,
)
from repro_torch.cluster.rebalance import Move, Rebalancer
from repro_torch.cluster.replication import (
    FaultInjector,
    ReplicaDown,
    ReplicaError,
    ReplicaSet,
    ReplicatedPandaDB,
    hedged_call,
    resilient_stream,
)
from repro_torch.cluster.scatter import (
    ClusterUnsupportedQuery,
    close_streams,
    fanout_anchor,
    id_bound_expr,
    ordered_merge,
)

__all__ = [
    "ClusterCursor",
    "ClusterPreparedStatement",
    "ClusterSession",
    "ClusterUnsupportedQuery",
    "FaultInjector",
    "Move",
    "Rebalancer",
    "ReplicaDown",
    "ReplicaError",
    "ReplicaSet",
    "ReplicatedPandaDB",
    "ShardMap",
    "ShardedPandaDB",
    "TEMP_BLOB_BASE",
    "close_streams",
    "default_owner_fn",
    "fanout_anchor",
    "hedged_call",
    "id_bound_expr",
    "make_shard",
    "ordered_merge",
    "owner_shard",
    "resilient_stream",
    "stable_id_hash",
]
