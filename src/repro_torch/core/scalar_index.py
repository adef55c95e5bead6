"""Numeric + text semantic-information indexes (paper §VI-B2).

"PANDADB adopts different index methods for a different type of semantic
information: for numerical data, the semantic index is based on B-Tree;
inverted index is adopted for semantic information under the format of
strings and texts."  Vectors live in `vector_index.py` (IVF); this module
covers the other two semantic spaces:

  * :class:`NumericIndex` -- sorted-key array with binary search (the B-tree
    role: O(log n) point/range lookups over e.g. `photo->jerseyNumber`).
  * :class:`InvertedIndex` -- token -> posting list (labels/words, e.g.
    `photo->animal = 'cat'` or OCR'd text CONTAINS 'tobacco').

Both carry the extracting model's serial number and are invalidated on model
update, exactly like the vector index.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class NumericIndex:
    keys: np.ndarray           # sorted float64 [N]
    ids: np.ndarray            # item ids aligned with keys
    serial: int = 1

    @staticmethod
    def build(values: Sequence[float], ids: Sequence[int],
              serial: int = 1) -> "NumericIndex":
        keys = np.asarray(values, np.float64)
        ids = np.asarray(ids, np.int64)
        order = np.argsort(keys, kind="stable")
        return NumericIndex(keys[order], ids[order], serial)

    def eq(self, value: float) -> np.ndarray:
        lo = np.searchsorted(self.keys, value, side="left")
        hi = np.searchsorted(self.keys, value, side="right")
        return self.ids[lo:hi]

    def range(self, lo: Optional[float] = None, hi: Optional[float] = None,
              inclusive: bool = True) -> np.ndarray:
        l = 0 if lo is None else np.searchsorted(
            self.keys, lo, side="left" if inclusive else "right")
        h = len(self.keys) if hi is None else np.searchsorted(
            self.keys, hi, side="right" if inclusive else "left")
        return self.ids[l:h]

    def insert(self, value: float, item_id: int) -> None:
        """Dynamic building (new unstructured item)."""
        pos = int(np.searchsorted(self.keys, value))
        self.keys = np.insert(self.keys, pos, value)
        self.ids = np.insert(self.ids, pos, item_id)


@dataclasses.dataclass
class InvertedIndex:
    postings: Dict[str, np.ndarray]
    serial: int = 1

    @staticmethod
    def build(tokens_per_item: Sequence[Iterable[str]], ids: Sequence[int],
              serial: int = 1) -> "InvertedIndex":
        acc: Dict[str, List[int]] = defaultdict(list)
        for item_id, tokens in zip(ids, tokens_per_item):
            if isinstance(tokens, str):
                tokens = tokens.split()
            for t in set(tokens):
                acc[str(t).lower()].append(int(item_id))
        return InvertedIndex(
            {t: np.asarray(sorted(v), np.int64) for t, v in acc.items()},
            serial)

    def lookup(self, token: str) -> np.ndarray:
        return self.postings.get(str(token).lower(), np.array([], np.int64))

    def lookup_all(self, tokens: Iterable[str]) -> np.ndarray:
        """AND-semantics posting intersection."""
        out: Optional[np.ndarray] = None
        for t in tokens:
            p = self.lookup(t)
            out = p if out is None else np.intersect1d(out, p)
        return out if out is not None else np.array([], np.int64)

    def insert(self, tokens: Iterable[str], item_id: int) -> None:
        if isinstance(tokens, str):
            tokens = tokens.split()
        for t in set(tokens):
            t = str(t).lower()
            p = self.postings.get(t, np.array([], np.int64))
            self.postings[t] = np.unique(np.append(p, item_id))

    @property
    def vocabulary(self) -> List[str]:
        return sorted(self.postings)
