"""Plain PyTorch version of the PQ ADC scan: LUT-sum scores + top-k.

Asymmetric distance computation (ADC): the corpus lives as uint8 PQ codes
``codes[N, M]`` and each query is a per-subspace table ``luts[Q, M, K]`` of
scores (higher = better).  The scan is M table gathers and adds per row.
Optional terms carry residual PQ and the fused whole-table scan:

* ``bias [N]`` -- a per-row additive constant;
* ``row_bucket [N]`` + ``cscores [Q, MB]`` -- adds ``cscores[q,
  row_bucket[n]]``;
* ``row_bucket [N]`` + ``probe_mask [Q, MB]`` -- rows whose bucket the query
  did not probe go to -inf, and their result positions to (-inf, -1).

The sum runs j = 0..M-1 from zero, then ``+ bias``, then ``+ cscores``: the
reference XLA twin's order, so the CUDA kernel matches this bitwise.  Ties
go to the lower row, as ``lax.top_k`` gives them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.topk import (radix_select_ref, sort_survivors,
                                      stable_topk)

#: the kernel's pin for non-probed rows, below every real score
NEG = -3.0e38


def pq_scores_ref(luts: torch.Tensor, codes: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  row_bucket: Optional[torch.Tensor] = None,
                  cscores: Optional[torch.Tensor] = None,
                  probe_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[Q, M, K] x [N, M] -> [Q, N]: sum_j luts[q, j, codes[n, j]]
    (+ bias[n] + cscores[q, row_bucket[n]], non-probed buckets -> -inf)."""
    luts = luts.float()
    codes = codes.long()
    qn, m, _k = luts.shape
    s = torch.zeros((qn, codes.shape[0]), dtype=torch.float32,
                    device=luts.device)
    for j in range(m):
        s = s + luts[:, j, :][:, codes[:, j]]
    if bias is not None:
        s = s + bias.float()[None, :]
    if row_bucket is not None:
        rb = row_bucket.long()
        if cscores is not None:
            s = s + cscores.float()[:, rb]
        if probe_mask is not None:
            s = torch.where(probe_mask.bool()[:, rb], s, -torch.inf)
    return s


def pq_adc_topk_ref(luts: torch.Tensor, codes: torch.Tensor, k: int,
                    n_valid: int = -1, bias: Optional[torch.Tensor] = None,
                    row_bucket: Optional[torch.Tensor] = None,
                    cscores: Optional[torch.Tensor] = None,
                    probe_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, M, K] x [N, M] -> (scores [Q, k] f32, rows [Q, k] int32).

    ``n_valid`` (< N) masks trailing padding rows to -inf.  With
    ``probe_mask``, positions past a query's probed rows hold (-inf, -1)."""
    s = pq_scores_ref(luts, codes, bias=bias, row_bucket=row_bucket,
                      cscores=cscores, probe_mask=probe_mask)
    if 0 <= n_valid < s.shape[1]:
        s[:, n_valid:] = -torch.inf
    vals, idx = stable_topk(s, k)
    idx = idx.to(torch.int32)
    if probe_mask is not None:
        idx = torch.where(torch.isfinite(vals), idx, -1)
    return vals, idx


def pq_adc_select_ref(luts: torch.Tensor, codes: torch.Tensor, k: int,
                      n_valid: int = -1, bias: Optional[torch.Tensor] = None,
                      row_bucket: Optional[torch.Tensor] = None,
                      cscores: Optional[torch.Tensor] = None,
                      probe_mask: Optional[torch.Tensor] = None,
                      n_seg: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel route in plain torch: the scores with non-probed rows
    pinned to NEG, :func:`radix_select_ref` over the first ``n_valid``
    columns (in ``n_seg`` segments), the stable sort of the survivors, then
    NEG back to (-inf, -1) as the wrapper does -> equal to
    :func:`pq_adc_topk_ref`."""
    s = pq_scores_ref(luts, codes, bias=bias, row_bucket=row_bucket,
                      cscores=cscores)
    if probe_mask is not None:
        s = torch.where(probe_mask.bool()[:, row_bucket.long()], s, NEG)
    if n_valid < 0 or n_valid > codes.shape[0]:
        n_valid = codes.shape[0]
    vals, rows = sort_survivors(*radix_select_ref(s, n_valid, k, n_seg), k)
    if probe_mask is not None:
        vals = torch.where(vals <= NEG / 2, -torch.inf, vals)
        rows = torch.where(torch.isfinite(vals), rows, -1)
    return vals, rows
