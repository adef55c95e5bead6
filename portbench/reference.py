"""Plain reference of PandaDB's IVF-Flat index and its batched kNN.

Algorithm 2 (BatchIndexing) as the paper states it: m = max(min_buckets,
n // vectors_per_bucket) buckets, random core vectors drawn by
``numpy.random.default_rng(seed).choice``, a few k-means refinements
(assign every row to its best core, each core the mean of its rows), every
row assigned to its best core, rows laid out bucket by bucket in their
original order.  A kNN probes each query's ``nprobe`` best buckets, scores
every row they hold and keeps the k best, ties to the lower row of that
layout.

Written in plain PyTorch over the benchmark's own inputs; it imports
nothing of the program.  ``precision`` is ``"float64"`` (the reference),
``"float32"`` (TF32 off) or ``"tf32"``: float32 with every product's
operands rounded to TF32's 10-bit mantissa and summed in float32, what a
TF32 tensor core computes (the control).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32")


@contextlib.contextmanager
def _no_tf32():
    """float32 products stay float32 on the card while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, half away from
    zero, as the tensor cores' conversion rounds)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-9)


def _product(a: torch.Tensor, b: torch.Tensor, precision: str
             ) -> torch.Tensor:
    """a [M, d] @ b [N, d].T in ``precision``."""
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    with _no_tf32():
        return a @ b.T


def scores(q: torch.Tensor, x: torch.Tensor, metric: str,
           precision: str = "float64") -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N], higher is closer."""
    dt = _dtype(precision)
    q, x = q.to(dt), x.to(dt)
    if metric == "cosine":
        return _product(unit(q), unit(x), precision)
    if metric == "ip":
        return _product(q, x, precision)
    if metric != "l2":
        raise ValueError(f"unknown metric {metric!r}")
    q2 = (q * q).sum(1, keepdim=True)
    x2 = (x * x).sum(1)
    return -(q2 - 2.0 * _product(q, x, precision) + x2[None, :])


def n_buckets(n: int, index: dict) -> int:
    m = max(int(index["min_buckets"]), n // int(index["vectors_per_bucket"]))
    return min(m, max(1, n))


def _assign(x: torch.Tensor, cores: torch.Tensor, metric: str,
            precision: str, block: int = 1 << 18) -> torch.Tensor:
    return torch.cat([scores(x[i:i + block], cores, metric,
                             precision).argmax(1)
                      for i in range(0, x.shape[0], block)])


def kmeans(x: torch.Tensor, index: dict, seed: int,
           precision: str = "float64", iters: int = -1
           ) -> Dict[str, torch.Tensor]:
    """Algorithm 2 over rows ``x`` [n, d]: {"centroids" [m, d] (the
    precision's dtype), "bucket" [n] (each row's bucket), "init" [m] (the
    rows drawn as cores)}.  ``iters`` < 0 runs the configuration's
    refinements."""
    n = x.shape[0]
    m = n_buckets(n, index)
    metric = index["metric"]
    iters = int(index["kmeans_iters"]) if iters < 0 else iters
    init = np.random.default_rng(int(seed)).choice(n, size=m, replace=False)
    xd = x.to(_dtype(precision))
    cores = xd[torch.as_tensor(init, device=x.device)].clone()
    for _ in range(iters):
        a = _assign(xd, cores, metric, precision)
        for b in range(m):
            sel = a == b
            if bool(sel.any()):
                cores[b] = xd[sel].mean(0)
    return {"centroids": cores, "bucket": _assign(xd, cores, metric,
                                                   precision),
            "init": torch.as_tensor(init)}


def layout(bucket: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, bucket_of): rows sorted by bucket, each bucket in row order."""
    ids = torch.sort(bucket, stable=True).indices
    return ids, bucket[ids]


def search(centroids: torch.Tensor, bucket: torch.Tensor, x: torch.Tensor,
           q: torch.Tensor, k: int, nprobe: int, metric: str,
           precision: str = "float64") -> Tuple[np.ndarray, np.ndarray]:
    """The batched kNN over the index (centroids, each row's bucket) of rows
    ``x``: (scores [Q, k] float32, row ids [Q, k] int64), in descending
    score, ties to the lower position of the bucket layout."""
    ids, bucket_of = layout(bucket)
    m = centroids.shape[0]
    cs = scores(q, centroids, metric, precision)
    probe = torch.sort(cs, dim=1, descending=True,
                       stable=True).indices[:, :min(nprobe, m)]
    mask = torch.zeros(cs.shape, dtype=torch.bool, device=cs.device)
    mask.scatter_(1, probe, True)
    s = scores(q, x[ids], metric, precision)
    s = torch.where(mask[:, bucket_of], s, -torch.inf)
    vals, pos = torch.sort(s, dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    out_ids = torch.where(torch.isfinite(vals), ids[pos], -1)
    return vals.float().cpu().numpy(), out_ids.cpu().numpy()
