"""The comparison that decides ``correct`` for the batched kNN.

The reference (``reference.py``) works the index out again from the
benchmark's own rows and seed, and judges what the program produced:

* the build: ``centroid_err``, the farthest the program's centroids lie
  from the reference's k-means, over the rows' largest norm; and
  ``assign_gap``, the most by which a row's bucket scores below its best
  bucket, by the program's centroids in float64, over the score's scale.
  K-means in float32 takes another path than in float64 (a few rows near a
  boundary flip and move the means), so the search is judged against the
  program's own centroids and buckets, which these two numbers hold;
* the probe, the scan and the selection, for every answer of a sample of
  the window's batches: ``rank_gap``, the most by which the j-th returned
  row scores (float64) below the j-th best row of the buckets the query
  must probe; ``score_err``, the most by which a returned score differs
  from that row's float64 score; ``bad_ids``, rows returned twice, out of
  range, or in a bucket the query does not probe; ``order_err``, answers
  out of descending order or, among equal returned scores, out of the
  layout's row order (the tie rule).  Gaps and errors are over the
  query's score scale: ||q||^2 + max ||x||^2 for l2, 1 for cosine,
  ||q|| max ||x|| for ip.

A bucket whose float64 score lies within ``AMBIGUOUS`` (over the scale) of
the probe's boundary may or may not be probed: a float32 probe can take
either.  The must-probe set leaves such buckets out, the may-probe set
takes them in.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from portbench import reference

#: the float64 score margin, over the score's scale, within which a bucket
#: ties the probe's boundary: ~100x the rounding of a float32 128-term score
AMBIGUOUS = 1e-5


def _scale(q: torch.Tensor, r2: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return torch.ones(q.shape[0], dtype=torch.float64, device=q.device)
    q2 = (q * q).sum(1)
    if metric == "ip":
        return torch.sqrt(q2 * r2)
    return q2 + r2


def bucket_per_row(state: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """Each row's bucket in the program's index, or None where its ids are
    not every row once."""
    ids = np.asarray(state["ids"], np.int64)
    if ids.shape != (n,) or not np.array_equal(np.sort(ids), np.arange(n)):
        return None
    bucket = np.empty(n, np.int64)
    bucket[ids] = np.asarray(state["bucket_of"], np.int64)
    return bucket


def build_numbers(rows: np.ndarray, index: dict, seed: int,
                  state: Dict[str, np.ndarray],
                  device: torch.device) -> Dict[str, float]:
    """``centroid_err`` and ``assign_gap`` of the program's index ``state``
    (centroids, bucket_of, ids) over ``rows``."""
    x = torch.from_numpy(rows).to(device)
    ref = reference.kmeans(x, index, seed)["centroids"]
    x = x.double()
    cp = torch.from_numpy(np.asarray(state["centroids"])).to(device).double()
    out = {"centroid_err": float("inf"), "assign_gap": float("inf")}
    if cp.shape == ref.shape:
        r = torch.linalg.vector_norm(x, dim=1).max()
        out["centroid_err"] = float(
            (torch.linalg.vector_norm(cp - ref, dim=1).max() / r).item())
    bucket = bucket_per_row(state, x.shape[0])
    if bucket is None or bucket.max() >= cp.shape[0] or bucket.min() < 0:
        return out
    b = torch.from_numpy(bucket).to(device)
    c2 = (cp * cp).sum(1).max()
    worst = 0.0
    for i in range(0, x.shape[0], 1 << 18):
        xb = x[i:i + (1 << 18)]
        s = reference.scores(xb, cp, index["metric"])
        gap = s.max(1).values - s.gather(1, b[i:i + len(xb), None])[:, 0]
        worst = max(worst, float((gap / _scale(xb, c2, index["metric"])
                                  ).max().item()))
    out["assign_gap"] = worst
    return out


def search_numbers(rows: np.ndarray, queries: np.ndarray,
                   answers: Iterable[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]],
                   state: Dict[str, np.ndarray], metric: str, k: int,
                   nprobe: int, device: torch.device) -> Dict[str, float]:
    """``rank_gap``, ``score_err``, ``bad_ids``, ``order_err`` and
    ``answers`` (positions compared) over ``answers``: (query indices,
    scores [B, k], ids [B, k]) of the program's batches."""
    x = torch.from_numpy(rows).to(device).double()
    n = x.shape[0]
    bucket_np = bucket_per_row(state, n)
    out = {"rank_gap": 0.0, "score_err": 0.0, "bad_ids": 0,
           "order_err": 0, "answers": 0}
    if bucket_np is None:
        out.update(rank_gap=float("inf"), bad_ids=n)
        return out
    bucket = torch.from_numpy(bucket_np).to(device)
    cp = torch.from_numpy(np.asarray(state["centroids"])).to(device).double()
    m = cp.shape[0]
    r2 = (x * x).sum(1).max()
    key = bucket * n + torch.arange(n, device=device)   # layout position
    for qi, vals, ids in answers:
        q = torch.from_numpy(queries[qi]).to(device).double()
        scale = _scale(q, r2, metric)[:, None]
        cs = reference.scores(q, cp, metric)
        if nprobe >= m:
            must = may = torch.ones_like(cs, dtype=torch.bool)
        else:
            srt = torch.sort(cs, dim=1, descending=True).values
            eps = AMBIGUOUS * scale
            must = cs > srt[:, nprobe:nprobe + 1] + eps
            may = cs >= srt[:, nprobe - 1:nprobe] - eps
        s = reference.scores(q, x, metric)                  # [B, n]
        best = torch.topk(torch.where(must[:, bucket], s, -torch.inf),
                          min(k, n), dim=1).values
        v = torch.from_numpy(np.asarray(vals, np.float64)).to(device)
        i = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
        valid = (i >= 0) & (i < n)
        safe = torch.where(valid, i, 0)
        s_id = torch.where(valid, s.gather(1, safe), -torch.inf)
        has = torch.isfinite(best)
        cols = min(k, best.shape[1])
        gap = torch.where(has, (best - s_id[:, :cols]) / scale, -torch.inf)
        out["rank_gap"] = max(out["rank_gap"], float(gap.max().item()))
        err = torch.where(valid, (v - s_id).abs() / scale, 0.0)
        out["score_err"] = max(out["score_err"], float(err.max().item()))
        in_may = may.gather(1, bucket[safe])
        srt_i = torch.sort(torch.where(valid, i, -1 - torch.arange(
            i.shape[1], device=device)), dim=1).values
        dup = (srt_i[:, 1:] == srt_i[:, :-1]) & (srt_i[:, 1:] >= 0)
        out["bad_ids"] += int(((~valid)[:, :cols] & has).sum()
                              + (valid & ~in_may).sum() + dup.sum())
        both = valid[:, 1:] & valid[:, :-1]
        down = v[:, :-1] < v[:, 1:]
        tie = (v[:, :-1] == v[:, 1:]) & torch.isfinite(v[:, 1:]) & both \
            & (key[safe[:, :-1]] > key[safe[:, 1:]])
        out["order_err"] += int((down | tie).sum())
        out["answers"] += int(v.numel())
    return out

