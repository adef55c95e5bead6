"""The card's peaks and the work a kNN batch needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the full
700 W): float32 products run outside the tensor cores, since the port keeps
TF32 off.  The work is what the inputs need, whatever path the program
takes: every row of each query's probed buckets scored against it (a
multiply and an add a dimension), each row of the union of the batch's
probed buckets read once, the queries read once, each query's k (score,
id) pairs written once.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from portbench import reference

PEAK_FLOPS_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, n_bytes: float) -> float:
    """The least time the card could take: compute or memory, the larger."""
    return max(flops / PEAK_FLOPS_FP32, n_bytes / HBM_BYTES_PER_S)


def probe_masks(queries: np.ndarray, centroids: np.ndarray, metric: str,
                nprobe: int) -> np.ndarray:
    """[Q, m] True at each query's ``nprobe`` best buckets (float64)."""
    cs = reference.scores(torch.from_numpy(queries),
                          torch.from_numpy(np.asarray(centroids)), metric)
    m = cs.shape[1]
    top = torch.topk(cs, min(nprobe, m), dim=1).indices
    mask = torch.zeros(cs.shape, dtype=torch.bool).scatter_(1, top, True)
    return mask.numpy()


def knn_work(batches: Iterable[np.ndarray], probe: np.ndarray,
             bucket_rows: np.ndarray, dim: int, k: int) -> Dict[str, float]:
    """FLOPs, bytes and least seconds summed over ``batches`` (query
    indices into the rows of ``probe``); ``bucket_rows[b]`` is bucket b's
    row count."""
    rows_q = probe.astype(np.int64) @ bucket_rows.astype(np.int64)
    flops = n_bytes = least = 0.0
    for qi in batches:
        f = 2.0 * dim * float(rows_q[qi].sum())
        union = float(bucket_rows[probe[qi].any(0)].sum())
        b = 4.0 * dim * (union + len(qi)) + 8.0 * k * len(qi)
        flops, n_bytes, least = flops + f, n_bytes + b, least + least_s(f, b)
    return {"flops": flops, "bytes": n_bytes, "least_s": least}
