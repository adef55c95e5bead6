"""Top-k in the reference's order: descending score, ties to the lower index.

``jax.lax.top_k`` breaks ties by index and ``torch.topk`` does not, so every
top-k of the port goes through a stable descending sort.  The scan kernels
leave per-tile candidates sorted in that order, laid out tile by tile, so the
same stable sort over the candidates merges them into the global order."""
from __future__ import annotations

from typing import Tuple

import torch


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Top-``k`` of each row of ``scores`` [Q, N]: (values, int64 columns)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def merge_tile_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Epilogue of the tile scans: [Q, n_tiles * L] candidates, each tile's
    run sorted (value desc, row asc) -> global top-``k`` (vals f32, rows
    int32).  A stable sort keeps the lower tile, and so the lower row, first
    among equal values."""
    vals, pos = stable_topk(cand_v, k)
    return vals, torch.gather(cand_i, 1, pos)
