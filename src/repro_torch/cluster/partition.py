"""Hash partitioning for the sharded cluster (paper §VII-A).

Layout rules (what lives where):

* **nodes** -- partitioned by
  :func:`repro_torch.core.vector_index.stable_id_hash` of the node id.
  Every shard keeps the full node-id space + labels (structure is
  replicated, so ids stay global and cheap), but properties, blobs and
  scan rows exist only on the owner (``GraphStore.owned``).
* **edges** -- co-located with their *source* node: an out-expand from an
  owned node never leaves the shard.
* **index metadata** -- IVF centroids + PQ codebooks replicated on every
  shard; bucket contents partitioned per shard via ``IVFIndex.shard()``
  with an explicit owner assignment, so a shard's index piece covers
  exactly the blobs its graph slice owns (index pushdown stays shard-local
  and exact).
* **query-side blobs** -- ``createFromSource`` literals materialize per
  shard in a reserved high id range (:data:`TEMP_BLOB_BASE`), disjoint
  from the coordinator's global data-blob sequence, so a temp blob can
  never alias a data blob's φ cache entries.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.pandadb import PandaDBConfig
from repro_torch.core.database import PandaDB
from repro_torch.core.vector_index import (  # noqa: F401
    owner_shard,
    stable_id_hash,
)
from repro_torch.device import DeviceLike

#: auto-allocated (query-side / temp) blob ids start here on every shard;
#: coordinator-assigned data blob ids stay far below
TEMP_BLOB_BASE = 1 << 40


def make_shard(cfg: Optional[PandaDBConfig] = None,
               wal_path: Optional[str] = None,
               device: DeviceLike = None) -> PandaDB:
    """One shard replica: a PandaDB on ``device`` (default: the CUDA card)
    whose store tracks ownership and whose blob store auto-allocates only
    from the temp range."""
    db = PandaDB(cfg, wal_path, device=device)
    db.graph.store.enable_ownership()
    db.graph.blobs._next_id = TEMP_BLOB_BASE
    return db


def default_owner_fn(n_shards: int):
    """ids -> owning shard, the stable-hash default (injectable in tests to
    force skewed / degenerate partitions)."""
    def fn(ids: np.ndarray) -> np.ndarray:
        return owner_shard(np.asarray(ids), n_shards)
    return fn


class ShardMap:
    """Node -> owning shard as a *versioned, mutable* assignment.

    The base function is the stable-hash default (or an injected policy);
    ``overrides`` records per-node moves (rebalance / dead-shard recovery)
    and ``active`` the shards currently serving.  Base assignments landing
    on a retired shard are re-dealt among the survivors by re-hashing --
    the same rule :meth:`Rebalancer.recovery_targets` uses, so new nodes
    created after a recovery agree with the recovered layout.

    Every topology change bumps ``epoch``; the coordinator folds it into
    the plan-cache key and its statistics epoch so no cached plan or
    shard-positional cost term outlives the assignment it was computed
    for."""

    def __init__(self, n_shards: int,
                 base_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None
                 ) -> None:
        self.n_shards = int(n_shards)
        self.base_fn = base_fn or default_owner_fn(self.n_shards)
        self.overrides: Dict[int, int] = {}
        self.active: List[int] = list(range(self.n_shards))
        self.epoch = 0

    def owner(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        out = np.array(self.base_fn(ids), np.int64, copy=True)
        if len(self.active) != self.n_shards:
            act = np.asarray(self.active, np.int64)
            dead = ~np.isin(out, act)
            if dead.any():
                out[dead] = act[owner_shard(ids[dead], len(act))]
        if self.overrides:
            for i, nid in enumerate(ids.tolist()):
                ov = self.overrides.get(int(nid))
                if ov is not None:
                    out[i] = ov
        return out

    def reassign(self, targets: Dict[int, int]) -> None:
        """Move nodes to explicit owners (one epoch bump per batch)."""
        if not targets:
            return
        for nid, shard in targets.items():
            self.overrides[int(nid)] = int(shard)
        self.epoch += 1

    def retire(self, shard: int) -> None:
        """Take a (dead) shard out of serving; its base-hash slice re-deals
        among the survivors."""
        if shard in self.active:
            if len(self.active) == 1:
                raise ValueError("cannot retire the last active shard")
            self.active.remove(shard)
            self.epoch += 1
