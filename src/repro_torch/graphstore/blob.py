"""BLOB storage (paper §VI-A, Fig 5 bottom).

Metadata (length, mime type, id -- the paper's "28.5 bytes") lives in the
property store; literal content is split by size:

  * < ``inline_threshold`` (10 kB): stored inline like long strings,
  * >= threshold: handed to the :class:`BlobValueManager`, a sharded
    BLOB-table addressed ``row = id // n_cols``, ``col = id % n_cols``
    (the paper's HBase layout); reads stream in chunks.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.configs.pandadb import BlobStoreConfig


@dataclasses.dataclass(frozen=True)
class Blob:
    blob_id: int
    length: int
    mime: str

    @property
    def metadata_bytes(self) -> int:
        return 29  # length(8) + id(8) + mime tag(~13)


class BlobValueManager:
    """Sharded BLOB-table for large values (the HBase role)."""

    def __init__(self, n_cols: int, chunk: int = 64 * 1024) -> None:
        self.n_cols = n_cols
        self.chunk = chunk
        self._rows: Dict[int, Dict[int, bytes]] = {}

    def locate(self, blob_id: int) -> Tuple[int, int]:
        return blob_id // self.n_cols, blob_id % self.n_cols

    def put(self, blob_id: int, content: bytes) -> None:
        row, col = self.locate(blob_id)
        self._rows.setdefault(row, {})[col] = content

    def get(self, blob_id: int) -> Optional[bytes]:
        row, col = self.locate(blob_id)
        return self._rows.get(row, {}).get(col)

    def delete(self, blob_id: int) -> None:
        row, col = self.locate(blob_id)
        self._rows.get(row, {}).pop(col, None)

    def stream(self, blob_id: int) -> Iterator[bytes]:
        """Streaming read (paper: BLOB transfer engine<->manager is streaming)."""
        content = self.get(blob_id)
        if content is None:
            return
        for off in range(0, len(content), self.chunk):
            yield content[off:off + self.chunk]

    def shard_of(self, blob_id: int, n_shards: int) -> int:
        """Which cluster shard owns this blob (property data is sharded)."""
        row, _ = self.locate(blob_id)
        return row % n_shards


class BlobStore:
    """Front door: metadata + inline/managed content split at 10 kB."""

    def __init__(self, cfg: Optional[BlobStoreConfig] = None) -> None:
        self.cfg = cfg or BlobStoreConfig()
        self.meta: Dict[int, Blob] = {}
        self._inline: Dict[int, bytes] = {}
        self.manager = BlobValueManager(self.cfg.table_columns)
        self._next_id = 0

    def create(self, content: bytes, mime: str = "application/octet-stream",
               blob_id: Optional[int] = None) -> Blob:
        """Register content; ``blob_id`` lets a cluster coordinator assign
        ids from the *global* sequence so blob identity survives sharding
        (each shard's store then holds a disjoint slice of one id space)."""
        if blob_id is None:
            blob_id = self._next_id
            self._next_id += 1
        else:
            self._next_id = max(self._next_id, blob_id + 1)
        blob = Blob(blob_id, len(content), mime)
        self.meta[blob_id] = blob
        if len(content) < self.cfg.inline_threshold:
            self._inline[blob_id] = content
        else:
            self.manager.put(blob_id, content)
        return blob

    def resolve_source(self, source,
                       mime: Optional[str] = None) -> Tuple[bytes, str]:
        """Fetch a source's content without registering a blob -- lets
        callers validate/read everything up front and defer registration
        until the whole statement is known to succeed."""
        if isinstance(source, bytes):
            return source, mime or "application/octet-stream"
        if isinstance(source, np.ndarray):
            return source.tobytes(), mime or "application/x-ndarray"
        if isinstance(source, str):
            if source.startswith(("http://", "https://")):
                # offline container: content-addressed synthetic payload
                seed = int(hashlib.sha256(source.encode()).hexdigest()[:8], 16)
                rng = np.random.default_rng(seed)
                return rng.bytes(2048), mime or "application/x-url"
            with open(source, "rb") as f:
                return f.read(), mime or "application/octet-stream"
        raise TypeError(f"unsupported blob source: {type(source)}")

    def create_from_source(self, source, mime: Optional[str] = None) -> Blob:
        """The CypherPlus *literal function* ``createFromSource``: URL, file
        path, bytes, or ndarray."""
        content, mime = self.resolve_source(source, mime)
        return self.create(content, mime)

    def read(self, blob_id: int) -> Optional[bytes]:
        if blob_id in self._inline:
            return self._inline[blob_id]
        return self.manager.get(blob_id)

    def delete(self, blob_id: int) -> None:
        """Drop content + metadata (a rebalance move takes the payload off
        the old owner once the new owner has registered it)."""
        self.meta.pop(blob_id, None)
        self._inline.pop(blob_id, None)
        self.manager.delete(blob_id)

    def stream(self, blob_id: int) -> Iterator[bytes]:
        if blob_id in self._inline:
            yield self._inline[blob_id]
            return
        yield from self.manager.stream(blob_id)

    def as_array(self, blob_id: int, dtype=np.uint8) -> np.ndarray:
        content = self.read(blob_id)
        if content is None:
            return np.array([], dtype)
        return np.frombuffer(content, dtype=dtype)
