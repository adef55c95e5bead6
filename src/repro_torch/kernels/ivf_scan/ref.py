"""Plain PyTorch version of the IVF scan: exact fused scores + top-k.

The arithmetic of the reference's XLA twin (``_scan_topk_xla``): one
matrix product for the scores, padding rows masked to -inf, then a top-k
in ``lax.top_k`` order (ties to the lower row).  With a probe mask, the
rows of each query's non-probed buckets are -inf too, as in the
reference's dense probe scan (``masked_scan_topk``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.topk import radix_select_ref, stable_topk


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit norm, the norm floored at 1e-9 (cosine)."""
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-9)


def scores_ref(q: torch.Tensor, corpus: torch.Tensor, metric: str
               ) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N] scores, higher = closer."""
    qf = q.float()
    cf = corpus.float()
    if metric == "ip":
        return qf @ cf.T
    if metric == "cosine":
        return normalize_rows(qf) @ normalize_rows(cf).T
    q2 = torch.sum(qf * qf, dim=-1, keepdim=True)
    c2 = torch.sum(cf * cf, dim=-1)
    return -(q2 - 2.0 * (qf @ cf.T) + c2[None, :])


def mask_scores(s: torch.Tensor, row_bucket: Optional[torch.Tensor],
                probe_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores [Q, N] with row n of query q at -inf unless
    ``probe_mask[q, row_bucket[n]]`` is set (no mask: ``s`` as it is)."""
    if probe_mask is None:
        return s
    return torch.where(probe_mask.bool()[:, row_bucket.long()], s,
                       -torch.inf)


def ivf_scan_topk_ref(q: torch.Tensor, corpus: torch.Tensor, k: int,
                      metric: str = "l2", n_valid: int = -1,
                      row_bucket: Optional[torch.Tensor] = None,
                      probe_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, d] x [N, d] -> (scores [Q, k] f32, rows [Q, k] int32).

    ``n_valid`` (< N) masks trailing padding rows to -inf, ``probe_mask``
    each query's non-probed buckets' rows (:func:`mask_scores`)."""
    s = mask_scores(scores_ref(q, corpus, metric), row_bucket, probe_mask)
    if 0 <= n_valid < corpus.shape[0]:
        s[:, n_valid:] = -torch.inf
    vals, idx = stable_topk(s, k)
    return vals, idx.to(torch.int32)


# -- the kernel route, step by step -----------------------------------------


def ivf_scan_select_ref(q: torch.Tensor, corpus: torch.Tensor, k: int,
                        metric: str = "l2", n_valid: int = -1,
                        row_bucket: Optional[torch.Tensor] = None,
                        probe_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel route in plain torch: scores (masked as the scoring
    kernel's epilogue masks them), :func:`radix_select_ref`, then a stable
    sort of the k survivors -> (scores [Q, k], rows [Q, k] int32), equal to
    :func:`ivf_scan_topk_ref`."""
    if n_valid < 0 or n_valid > corpus.shape[0]:
        n_valid = corpus.shape[0]
    s = mask_scores(scores_ref(q, corpus, metric), row_bucket, probe_mask)
    vals, rows = radix_select_ref(s, n_valid, k)
    order_v, pos = stable_topk(vals, k)
    return order_v, torch.gather(rows, 1, pos)
