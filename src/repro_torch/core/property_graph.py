"""Property-graph data model with unstructured extension (paper §III).

UG = <G, SK, φ>: a property graph G whose properties may be BLOBs, a set of
sub-property keys SK, and extraction functions φ : (N∪R) × K × SK → SV.
φ itself lives in the AIPM registry (:mod:`repro_torch.core.aipm`); this module
stores the structural graph + properties and exposes the φ call path.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.configs.pandadb import PandaDBConfig
from repro_torch.graphstore.blob import Blob, BlobStore
from repro_torch.graphstore.stores import GraphStore
from repro_torch.graphstore.wal import WriteAheadLog


class PandaGraph:
    """G = <N, R, src, tgt, ι, λ, τ> plus BLOB properties and SK."""

    def __init__(self, cfg: Optional[PandaDBConfig] = None,
                 wal_path: Optional[str] = None) -> None:
        self.cfg = cfg or PandaDBConfig()
        self.store = GraphStore()
        self.blobs = BlobStore(self.cfg.blob)
        self.wal = WriteAheadLog(wal_path)
        self.sub_property_keys: set = set()   # SK

    # -- mutation (leader path: versioned via WAL) ---------------------------

    def create_node(self, label: str, log: bool = True, **props: Any) -> int:
        blob_props = {}
        for k, v in list(props.items()):
            if isinstance(v, (bytes, np.ndarray)) or isinstance(v, Blob):
                blob = v if isinstance(v, Blob) else self.blobs.create_from_source(v)
                props[k] = blob.blob_id
                blob_props[k] = blob.blob_id
        nid = self.store.add_node(label, **{k: v for k, v in props.items()
                                            if k not in blob_props})
        for k, bid in blob_props.items():
            self.store.node_props.set(nid, k, bid, kind="blob")
        if log:
            self.wal.append(f"CREATE NODE {label} {nid}")
        return nid

    def create_relationship(self, src: int, tgt: int, rel_type: str,
                            log: bool = True, **props: Any) -> int:
        rid = self.store.add_relationship(src, tgt, rel_type, **props)
        if log:
            self.wal.append(f"CREATE REL {rel_type} {src}->{tgt}")
        return rid

    # -- ι / λ / τ accessors ---------------------------------------------------

    def prop(self, node_id: int, key: str) -> Any:
        return self.store.node_props.get(node_id, key)

    def label(self, node_id: int) -> str:
        return self.store.labels.name_of(self.store.node_labels[node_id])

    def blob_of(self, node_id: int, key: str) -> Optional[Blob]:
        bid = self.store.node_props.get(node_id, key)
        if bid is None:
            return None
        return self.blobs.meta.get(int(bid))

    # -- scale helpers --------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self.store.n_nodes

    @property
    def n_relationships(self) -> int:
        return len(self.store.rels)

    def declare_sub_property(self, sub_key: str) -> None:
        self.sub_property_keys.add(sub_key)
