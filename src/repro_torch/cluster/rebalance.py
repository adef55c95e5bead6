"""Live rebalancing: move node ownership between shards (paper §VII-A).

The coordinator's :class:`~repro_torch.cluster.partition.ShardMap` is a
versioned assignment (base hash + per-node overrides + active-shard list);
the :class:`Rebalancer` changes it safely while the cluster serves:

1. **plan** -- diff a target assignment against current ownership
   (:meth:`Rebalancer.plan_moves`), or derive one from observed skew
   (:meth:`skew_targets`) / a dying shard (:meth:`recovery_targets`);
2. **ship** -- for each move, read the node's property payload + blob
   content + co-located out-edges from a live source replica and apply an
   ``adopt_node`` op on the destination (blob ids are preserved, so index
   identity survives the move); the source disowns the row and drops the
   payload;
3. **re-slice indexes** -- the gathered per-shard IVF pieces merge back
   into the exact build layout (``IVFIndex.merge_pieces``) and re-shard by
   the updated blob ownership (``IVFIndex.shard(assign=)``): no re-train,
   no re-extraction, byte-identical centroids/codes;
4. **publish** -- one shard-map epoch bump per batch (plus one for a
   retirement), which invalidates every cached plan: routing decisions
   bake in the topology.

Dead-shard recovery is a rebalance whose targets spread the dying shard's
rows over the survivors with the SAME rehash rule ``ShardMap.owner`` uses
for base assignments to inactive shards -- so nodes created after the
retirement land consistently with the recovered ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.database import PandaDB
from repro_torch.core.vector_index import IVFIndex
from repro_torch.cluster.coordinator import ShardedPandaDB
from repro_torch.cluster.partition import owner_shard
from repro_torch.cluster.replication import ReplicaDown


@dataclasses.dataclass(frozen=True)
class Move:
    node_id: int
    src: int
    dst: int


class Rebalancer:
    """Plans and executes ownership moves on a (replicated) coordinator."""

    def __init__(self, cdb: ShardedPandaDB) -> None:
        self.cdb = cdb

    # -- sources ---------------------------------------------------------------

    def _source_db(self, s: int) -> PandaDB:
        """A live db holding shard ``s``'s payload -- for a replicated
        cluster, any surviving replica (raises :class:`ReplicaDown` when
        the whole set is gone: then there is nothing left to recover)."""
        sets = getattr(self.cdb, "replica_sets", None)
        if sets is not None:
            rs = sets[s]
            return rs.replicas[rs.live()[0]]
        return self.cdb.shards[s]

    def owned_counts(self) -> Dict[int, int]:
        return {s: int(len(self._source_db(s).graph.store.owned_nodes()))
                for s in self.cdb.active}

    # -- planning --------------------------------------------------------------

    def plan_moves(self, target: Dict[int, int]) -> List[Move]:
        """Diff ``{node_id: shard}`` against current ownership; already-
        placed nodes drop out, so re-running a plan is idempotent."""
        return [Move(int(nid), self.cdb.owner_of(int(nid)), int(dst))
                for nid, dst in sorted(target.items())
                if self.cdb.owner_of(int(nid)) != int(dst)]

    def skew_targets(self, threshold: Optional[float] = None
                     ) -> Dict[int, int]:
        """Skew-triggered plan: when the hottest shard owns more than
        ``threshold``x the mean, move half its lead over the coldest shard
        there (highest-id rows move -- they are the youngest, so steady-
        state churn touches the fewest already-cold rows)."""
        cdb = self.cdb
        thr = (threshold if threshold is not None
               else cdb.cfg.cluster.rebalance_skew)
        counts = self.owned_counts()
        if len(counts) < 2:
            return {}
        mean = sum(counts.values()) / len(counts)
        order = sorted(counts)
        hot = max(order, key=lambda s: counts[s])
        cold = min(order, key=lambda s: counts[s])
        if mean <= 0 or counts[hot] < thr * mean:
            return {}
        n_move = (counts[hot] - counts[cold]) // 2
        if n_move <= 0:
            return {}
        nids = self._source_db(hot).graph.store.owned_nodes()
        return {int(n): cold for n in nids[-n_move:]}

    def recovery_targets(self, dead: int) -> Dict[int, int]:
        """Spread a dying shard's rows over the survivors with the exact
        rehash rule ``ShardMap.owner`` applies to inactive base
        assignments."""
        cdb = self.cdb
        survivors = [s for s in cdb.active if s != dead]
        if not survivors:
            raise ValueError(f"no surviving shards besides {dead}")
        nids = self._source_db(dead).graph.store.owned_nodes()
        if len(nids) == 0:
            return {}
        surv = np.asarray(survivors, np.int64)
        dst = surv[owner_shard(nids, len(survivors))]
        return {int(n): int(d) for n, d in zip(nids, dst)}

    # -- execution -------------------------------------------------------------

    def rebalance(self, target: Dict[int, int],
                  retire: Optional[int] = None) -> List[Move]:
        """Execute a target assignment (optionally retiring a shard after
        its rows are out).  Returns the moves performed."""
        cdb = self.cdb
        moves = self.plan_moves(target)
        if not moves and retire is None:
            return moves
        # snapshot index pieces from the CURRENT topology (the to-be-
        # retired shard included) before any payload moves
        sub_keys = list(self._source_db(cdb.active[0]).indexes)
        gathered = {sk: [self._source_db(s).indexes[sk] for s in cdb.active]
                    for sk in sub_keys}
        for mv in moves:
            self._ship(mv)
        cdb.shard_map.reassign({mv.node_id: mv.dst for mv in moves})
        if retire is not None:
            cdb.shard_map.retire(retire)
        # re-slice (not re-train): merge back into the build layout, cut by
        # the updated blob ownership, install on the new active set
        for sk in sub_keys:
            merged = IVFIndex.merge_pieces(gathered[sk])
            assign = np.asarray(
                [cdb._blob_owner[int(b)] for b in merged.ids], np.int64)
            pieces = merged.shard(cdb.n_shards, assign=assign)
            for s in cdb.active:
                cdb._shard_apply(s, "set_index", sk, pieces[s])
            cdb.stats.note_index_rebuild(sk)
        cdb.stats.note_topology_change()
        cdb._count("rebalance_moves", len(moves))
        return moves

    def _ship(self, mv: Move) -> None:
        """Move one node's payload: props + blob content + out-edges to the
        destination (``adopt_node``), disown + drop on the source."""
        cdb = self.cdb
        db = self._source_db(mv.src)
        store = db.graph.store
        nid = mv.node_id
        scalar: Dict[str, Any] = {}
        blob_specs: Dict[str, Tuple[int, bytes, str]] = {}
        for key, col in store.node_props.columns.items():
            if nid >= len(col.present) or not col.present[nid]:
                continue
            if col.kind == "blob":
                bid = int(col.values[nid])
                content = db.graph.blobs.read(bid)
                if content is None:
                    raise KeyError(f"blob {bid} of node {nid} has no "
                                   f"content on shard {mv.src}")
                blob_specs[key] = (bid, content, db.graph.blobs.meta[bid].mime)
            elif col.kind == "string":
                scalar[key] = col.values[nid]
            else:
                scalar[key] = float(col.values[nid])
        edges: List[Tuple[int, str, Dict[str, Any]]] = []
        rels = store.rels
        for eid in rels.out_edges(nid).tolist():
            rprops = {k: (c.values[eid] if c.kind == "string"
                          else float(c.values[eid]))
                      for k, c in store.rel_props.columns.items()
                      if eid < len(c.present) and c.present[eid]}
            edges.append((int(rels.tgt[eid]),
                          store.rel_types.name_of(rels.type_id[eid]),
                          rprops))
        cdb._shard_apply(mv.dst, "adopt_node", nid, scalar, blob_specs, edges)
        for _, (bid, _, _) in blob_specs.items():
            cdb._blob_owner[bid] = mv.dst
        try:
            cdb._shard_apply(mv.src, "set_owner", nid, False)
            for _, (bid, _, _) in blob_specs.items():
                cdb._shard_apply(mv.src, "drop_blob", bid)
        except ReplicaDown:
            pass    # the source set died mid-move: nothing left to disown
