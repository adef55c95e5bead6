"""Native graph storage (paper §VI-A, Fig 5), columnar adaptation.

Neo4j's record stores (nodestore / relationshipstore / propertystore /
labelstore, linked by nextRelId / nextPropId pointers) become struct-of-array
columns: the pointer chains are replaced by CSR adjacency (``out_ptr`` /
``out_idx``) which *is* index-free adjacency -- each node's slice of the CSR
row is its "micro-index for all nearby nodes", and traversal cost is
proportional to the subgraph visited, exactly the property the paper wants.

The graph-structure arrays are small and REPLICATED on every device (paper
§VII-A keeps a full copy of structure per cluster node); property columns are
the shardable payload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class LabelRegistry:
    """Interns label / relationship-type / property-key strings to ids."""

    def __init__(self) -> None:
        self._to_id: Dict[str, int] = {}
        self._to_name: List[str] = []

    def intern(self, name: str) -> int:
        if name not in self._to_id:
            self._to_id[name] = len(self._to_name)
            self._to_name.append(name)
        return self._to_id[name]

    def id_of(self, name: str) -> Optional[int]:
        return self._to_id.get(name)

    def name_of(self, idx: int) -> str:
        return self._to_name[idx]

    def __len__(self) -> int:
        return len(self._to_name)


@dataclasses.dataclass
class PropertyColumn:
    """One property key across all nodes: dense column + presence mask."""

    kind: str                      # numeric | string | blob
    values: Any                    # np.ndarray (numeric / blob ids) or list (string)
    present: np.ndarray            # bool [N]


class PropertyStore:
    """ι : (N ∪ R) × K → V as columnar storage with presence masks."""

    def __init__(self) -> None:
        self.columns: Dict[str, PropertyColumn] = {}
        self._capacity = 0

    def _grow(self, n: int) -> None:
        if n <= self._capacity:
            return
        new_cap = max(n, max(16, self._capacity * 2))
        for col in self.columns.values():
            pad = new_cap - len(col.present)
            col.present = np.concatenate([col.present, np.zeros(pad, bool)])
            if col.kind == "string":
                col.values.extend([None] * pad)
            else:
                col.values = np.concatenate(
                    [col.values, np.zeros(pad, col.values.dtype)])
        self._capacity = new_cap

    def _ensure_column(self, key: str, kind: str) -> PropertyColumn:
        if key not in self.columns:
            if kind == "string":
                values: Any = [None] * self._capacity
            elif kind == "blob":
                values = np.full(self._capacity, -1, np.int64)
            else:
                values = np.zeros(self._capacity, np.float64)
            self.columns[key] = PropertyColumn(
                kind, values, np.zeros(self._capacity, bool))
        col = self.columns[key]
        if col.kind != kind:
            raise TypeError(f"property {key!r} is {col.kind}, got {kind}")
        return col

    @staticmethod
    def _kind_of(value: Any) -> str:
        if isinstance(value, str):
            return "string"
        if isinstance(value, (int, float, np.integer, np.floating, bool)):
            return "numeric"
        return "blob"

    def set(self, item_id: int, key: str, value: Any, kind: Optional[str] = None) -> None:
        kind = kind or self._kind_of(value)
        self._grow(item_id + 1)
        col = self._ensure_column(key, kind)
        if kind == "string":
            col.values[item_id] = value
        elif kind == "blob":
            col.values[item_id] = int(value)
        else:
            col.values[item_id] = float(value)
        col.present[item_id] = True

    def get(self, item_id: int, key: str) -> Any:
        col = self.columns.get(key)
        if col is None or item_id >= len(col.present) or not col.present[item_id]:
            return None
        v = col.values[item_id]
        return v if col.kind == "string" else (int(v) if col.kind == "blob" else float(v))

    def column(self, key: str) -> Optional[PropertyColumn]:
        return self.columns.get(key)


class RelationshipStore:
    """Relationships as first-class entities with CSR adjacency both ways."""

    def __init__(self) -> None:
        self.src: List[int] = []
        self.tgt: List[int] = []
        self.type_id: List[int] = []
        self._csr_dirty = True
        self._out: Optional[Tuple[np.ndarray, np.ndarray]] = None  # ptr, (eid)
        self._in: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._n_nodes = 0
        # edge columns as arrays, cached alongside the CSR build: expand is
        # called per chunk, and re-converting the Python lists would cost
        # O(E) per call (invalidated in add(), same as the CSR)
        self._arr: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def add(self, src: int, tgt: int, type_id: int) -> int:
        rid = len(self.src)
        self.src.append(src)
        self.tgt.append(tgt)
        self.type_id.append(type_id)
        self._n_nodes = max(self._n_nodes, src + 1, tgt + 1)
        self._csr_dirty = True
        self._arr = None
        return rid

    def __len__(self) -> int:
        return len(self.src)

    def _build_csr(self, n_nodes: int) -> None:
        src, tgt, _tids = self._edge_arrays()
        eids = np.arange(len(src))

        def csr(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
            order = np.argsort(keys, kind="stable")
            counts = np.bincount(keys, minlength=n_nodes)
            ptr = np.zeros(n_nodes + 1, np.int64)
            np.cumsum(counts, out=ptr[1:])
            return ptr, eids[order]

        self._out = csr(src)
        self._in = csr(tgt)
        self._csr_dirty = False
        self._n_nodes = n_nodes

    def ensure_csr(self, n_nodes: int) -> None:
        if self._csr_dirty or self._n_nodes < n_nodes:
            self._build_csr(max(n_nodes, self._n_nodes))

    def out_edges(self, node: int) -> np.ndarray:
        self.ensure_csr(self._n_nodes)
        ptr, idx = self._out
        return idx[ptr[node]:ptr[node + 1]] if node + 1 < len(ptr) else np.array([], np.int64)

    def in_edges(self, node: int) -> np.ndarray:
        self.ensure_csr(self._n_nodes)
        ptr, idx = self._in
        return idx[ptr[node]:ptr[node + 1]] if node + 1 < len(ptr) else np.array([], np.int64)

    def _edge_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, tgt, type_id) as arrays, cached until the next add()."""
        if self._arr is None:
            self._arr = (np.asarray(self.src, np.int64),
                         np.asarray(self.tgt, np.int64),
                         np.asarray(self.type_id, np.int32))
        return self._arr

    def arrays(self) -> Dict[str, np.ndarray]:
        src, tgt, tid = self._edge_arrays()
        return {"src": src, "tgt": tgt, "type_id": tid}

    def expand_batch(self, nodes: np.ndarray, type_id: Optional[int],
                     direction: str = "out") -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized expand: returns (row_index, neighbor) pairs.

        ``row_index[i]`` says which input row neighbor[i] came from -- the
        variable-degree analogue of a flat join.
        """
        self.ensure_csr(self._n_nodes)
        ptr, idx = self._out if direction == "out" else self._in
        src_col, tgt_col, tids = self._edge_arrays()
        src_arr = tgt_col if direction == "out" else src_col
        nodes = np.asarray(nodes, np.int64)
        nodes_c = np.clip(nodes, 0, len(ptr) - 2)
        starts, ends = ptr[nodes_c], ptr[nodes_c + 1]
        degs = (ends - starts) * (nodes == nodes_c)
        row_index = np.repeat(np.arange(len(nodes)), degs)
        offsets = np.concatenate([[0], np.cumsum(degs)])[:-1]
        flat = np.arange(int(degs.sum())) - np.repeat(offsets, degs) + np.repeat(starts, degs)
        eids = idx[flat]
        if type_id is not None:
            keep = tids[eids] == type_id
            row_index, eids = row_index[keep], eids[keep]
        return row_index, src_arr[eids]


class GraphStore:
    """The assembled native store: nodes, relationships, labels, properties.

    Cluster mode (paper §VII-A): a shard's store keeps the full node-id
    space and every node's label (structure is replicated -- ids stay
    global and traversal metadata is cheap), but *owns* only its
    hash-partitioned slice: properties/blobs are populated and scans
    (:meth:`all_nodes` / :meth:`nodes_with_label`) emit rows only for owned
    nodes.  Single-node stores never enable the mask and pay nothing."""

    def __init__(self) -> None:
        self.labels = LabelRegistry()
        self.rel_types = LabelRegistry()
        self.n_nodes = 0
        self.node_labels: List[int] = []       # primary label id per node
        self.rels = RelationshipStore()
        self.node_props = PropertyStore()
        self.rel_props = PropertyStore()
        #: None = single-node store (owns every row).  A shard's store holds
        #: one bool per node slot; remote nodes keep label/edges-by-source
        #: structure but contribute no scan rows and no property payload.
        self.owned: Optional[List[bool]] = None
        self._owned_arr: Optional[np.ndarray] = None   # scan-path cache

    def enable_ownership(self) -> None:
        """Switch to sharded mode: existing and future nodes default to
        owned until :meth:`set_owner` says otherwise."""
        if self.owned is None:
            self.owned = [True] * self.n_nodes
            self._owned_arr = None

    def set_owner(self, node_id: int, owned: bool) -> None:
        if self.owned is None:
            self.enable_ownership()
        self.owned[node_id] = owned
        self._owned_arr = None

    def is_owned(self, node_id: int) -> bool:
        return self.owned is None or self.owned[node_id]

    def _owned_mask(self) -> np.ndarray:
        """Ownership as a bool array, cached until the next mutation (scans
        run per chunk per statement; converting the list each time would put
        an O(n) interpreter loop on the fan-out hot path)."""
        if self._owned_arr is None or len(self._owned_arr) != self.n_nodes:
            self._owned_arr = np.asarray(self.owned, bool)
        return self._owned_arr

    def owned_nodes(self) -> np.ndarray:
        if self.owned is None:
            return np.arange(self.n_nodes, dtype=np.int64)
        return np.nonzero(self._owned_mask())[0].astype(np.int64)

    def add_node(self, label: str, **props: Any) -> int:
        nid = self.n_nodes
        self.n_nodes += 1
        self.node_labels.append(self.labels.intern(label))
        if self.owned is not None:
            self.owned.append(True)
            self._owned_arr = None
        for k, v in props.items():
            self.node_props.set(nid, k, v)
        return nid

    def add_relationship(self, src: int, tgt: int, rel_type: str, **props: Any) -> int:
        rid = self.rels.add(src, tgt, self.rel_types.intern(rel_type))
        for k, v in props.items():
            self.rel_props.set(rid, k, v)
        return rid

    def nodes_with_label(self, label: str) -> np.ndarray:
        lid = self.labels.id_of(label)
        if lid is None:
            return np.array([], np.int64)
        hit = np.asarray(self.node_labels) == lid
        if self.owned is not None:
            hit &= self._owned_mask()
        return np.nonzero(hit)[0].astype(np.int64)

    def all_nodes(self) -> np.ndarray:
        return self.owned_nodes()
