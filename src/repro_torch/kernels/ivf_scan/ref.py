"""Plain PyTorch version of the IVF scan: exact fused scores + top-k.

The arithmetic of the reference's XLA twin (``_scan_topk_xla``): one
matrix product for the scores, padding rows masked to -inf, then a top-k
in ``lax.top_k`` order (ties to the lower row)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk import stable_topk


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


def ivf_scan_topk_ref(q: torch.Tensor, corpus: torch.Tensor, k: int,
                      metric: str = "l2", n_valid: int = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, d] x [N, d] -> (scores [Q, k] f32, rows [Q, k] int32).

    ``n_valid`` (< N) masks trailing padding rows to -inf."""
    s = scores_ref(q, corpus, metric)
    if 0 <= n_valid < corpus.shape[0]:
        s[:, n_valid:] = -torch.inf
    vals, idx = stable_topk(s, k)
    return vals, idx.to(torch.int32)
