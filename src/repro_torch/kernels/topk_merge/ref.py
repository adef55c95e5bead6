"""Plain PyTorch version of the k-way top-k merge: the cluster reduce step.

P shards each return a per-query top-k window ``(vals [P, Q, K], ids
[P, Q, K])``, with (val=-inf, id=-1) padding where a shard holds fewer than
K real rows.  The merge flattens the shard axis into ``C = P * K`` candidate
columns per query (column ``p * K + j`` is shard p's rank-j candidate),
masks columns ``>= n_valid`` to -inf and takes the top ``min(k, n_valid)``
in ``lax.top_k`` order: descending value, ties to the lower column.  Padding
columns are all -inf ties, so they sink below every real candidate and
surface in ascending column order carrying their id=-1 payload.

The arithmetic of the reference's XLA twin (``_merge_topk_xla``) and oracle
(``merge_topk_ref``).  The CPU path and the tests use it; a tensor on the
card goes to the CUDA kernel instead."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk import (radix_select_ref, sort_survivors,
                                      stable_topk)

#: the kernel's input floor: values at or below it are padding
CLAMP = -1.0e38


def merge_topk_ref(vals: torch.Tensor, ids: torch.Tensor, k: int,
                   n_valid: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, Q, K] x [P, Q, K] -> (vals [Q, k'] f32, ids [Q, k']),
    k' = min(k, n_valid), ids in the dtype given."""
    p, qn, kk = vals.shape
    c = p * kk
    flat_v = vals.to(torch.float32).permute(1, 0, 2).reshape(qn, c)
    flat_i = ids.permute(1, 0, 2).reshape(qn, c)
    if 0 <= n_valid < c:
        flat_v = flat_v.clone()
        flat_v[:, n_valid:] = -torch.inf
    else:
        n_valid = c
    mv, pos = stable_topk(flat_v, min(k, n_valid))
    return mv, torch.gather(flat_i, 1, pos)


def merge_select_ref(vals: torch.Tensor, ids: torch.Tensor, k: int,
                     n_valid: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's route for wide windows in plain torch: the [Q, P*K]
    columns clamped up to CLAMP, :func:`radix_select_ref` over the first
    ``n_valid``, the stable sort of the k survivors, -inf restored and the
    ids of their columns gathered -> equal to :func:`merge_topk_ref`."""
    p, qn, kk = vals.shape
    c = p * kk
    if n_valid < 0 or n_valid > c:
        n_valid = c
    k = min(k, n_valid)
    flat_v = vals.to(torch.float32).permute(1, 0, 2).reshape(qn, c)
    flat_v = torch.clamp_min(flat_v, CLAMP)
    mv, cols = sort_survivors(*radix_select_ref(flat_v, n_valid, k), k)
    picked = torch.gather(ids.permute(1, 0, 2).reshape(qn, c), 1, cols.long())
    return torch.where(mv <= CLAMP, -torch.inf, mv), picked
