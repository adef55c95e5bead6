"""Neighbor sampler (GraphSAGE minibatch training, paper regime
`minibatch_lg`): uniform fanout sampling over a CSR graph, emitting the
block-graph layout `launch/gnn_steps.py` consumes.

Host-side numpy (sampling is control plane); the emitted arrays are device
inputs.  Sampling with replacement when a node's degree < fanout, matching
the GraphSAGE reference.  The reference's ``data/sampler.py``, kept as the
port's own copy: given the same seed it gives the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    ptr: np.ndarray           # [N+1]
    idx: np.ndarray           # [E] neighbor ids
    feats: np.ndarray         # [N, d]
    labels: np.ndarray        # [N]

    @staticmethod
    def from_edges(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                   feats: np.ndarray, labels: np.ndarray) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        counts = np.bincount(dst, minlength=n_nodes)
        ptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        return CSRGraph(ptr, src[order].astype(np.int64), feats, labels)


class NeighborSampler:
    def __init__(self, graph: CSRGraph, fanout: Tuple[int, ...],
                 seed: int = 0) -> None:
        self.g = graph
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def _sample_neighbors(self, nodes: np.ndarray, k: int) -> np.ndarray:
        """[B] -> [B, k] sampled in-neighbors (with replacement; isolated
        nodes self-loop)."""
        starts = self.g.ptr[nodes]
        degs = self.g.ptr[nodes + 1] - starts
        r = self.rng.integers(0, np.maximum(degs, 1)[:, None],
                               size=(len(nodes), k))
        flat = self.g.idx[starts[:, None] + r]
        isolated = degs == 0
        flat[isolated] = nodes[isolated, None]
        return flat

    def sample_block(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """Emit the block-graph: nodes = [seeds | hop1 | hop2 ...],
        edges point hop k+1 -> hop k (message direction)."""
        b = len(seeds)
        levels = [seeds.astype(np.int64)]
        for k in self.fanout:
            levels.append(self._sample_neighbors(levels[-1], k).reshape(-1))
        all_nodes = np.concatenate(levels)
        offsets = np.cumsum([0] + [len(l) for l in levels])
        src_list, dst_list = [], []
        for li in range(1, len(levels)):
            lo_prev, lo = offsets[li - 1], offsets[li]
            n_prev = offsets[li] - offsets[li - 1]
            k = self.fanout[li - 1]
            dst = np.repeat(np.arange(lo_prev, lo_prev + n_prev), k)
            src = np.arange(lo, lo + n_prev * k)
            src_list.append(src)
            dst_list.append(dst)
        src = np.concatenate(src_list)
        dst = np.concatenate(dst_list)
        labels = np.full(len(all_nodes), -1, np.int64)
        labels[:b] = self.g.labels[seeds]
        return {
            "node_ids": all_nodes,
            "feats": self.g.feats[all_nodes],
            "src": src.astype(np.int32),
            "dst": dst.astype(np.int32),
            "edge_mask": np.ones(len(src), bool),
            "labels": labels.astype(np.int32),
        }

    def batches(self, batch_size: int, n_batches: int):
        labeled = np.nonzero(self.g.labels >= 0)[0]
        for _ in range(n_batches):
            seeds = self.rng.choice(labeled, size=batch_size,
                                    replace=len(labeled) < batch_size)
            yield self.sample_block(seeds)


def random_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
                 seed: int = 0) -> CSRGraph:
    """Synthetic power-law-ish graph for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    src, dst = power_law_edges(rng, n_nodes, n_nodes * avg_degree)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes)
    return CSRGraph.from_edges(n_nodes, src, dst, feats.astype(np.float32),
                               labels.astype(np.int64))


def power_law_edges(rng: np.random.Generator, n_nodes: int, n_edges: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``random_graph``'s endpoints, drawn from ``rng``: preferential-
    attachment-flavoured sources (Pareto weights), uniform destinations
    (int64 each).  ``random_graph`` draws exactly these first, so a caller
    that needs an edge count that is not a multiple of the node count gets
    the same recipe."""
    w = rng.pareto(2.0, n_nodes) + 1.0
    p = w / w.sum()
    src = rng.choice(n_nodes, n_edges, p=p)
    dst = rng.integers(0, n_nodes, n_edges)
    return src, dst
