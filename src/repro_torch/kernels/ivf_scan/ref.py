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


# -- the kernel route's selection, step by step -------------------------------


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """float32 scores -> int64 keys in [0, 2**32) in the scores' order, as
    ``ivf_select`` forms them (-0 and +0 get one key)."""
    u = scores.float().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def radix_select_ref(scores: torch.Tensor, n_valid: int, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``ivf_select`` computes, in plain torch: per row of scores
    [Q, >= n_valid], its top-``k`` among the first ``n_valid`` columns, in
    column order: (vals [Q, k] f32, cols [Q, k] int32).

    Three digit passes over the order keys (11, 11 and 10 bits, most
    significant first) find the digits of the k-th largest key: a pass
    histograms the keys that match the digits chosen so far and picks the
    digit whose bin holds the k-th; a row stops once that bin holds exactly
    the keys still needed.  Then every key above the threshold is kept, and
    of the keys equal to it the first in column order (``lax.top_k``'s tie
    rule)."""
    key = order_keys(scores[:, :n_valid])
    qn = key.shape[0]
    dev = key.device
    prefix = torch.zeros(qn, dtype=torch.int64, device=dev)
    mask = torch.zeros(qn, dtype=torch.int64, device=dev)
    need = torch.full((qn,), k, dtype=torch.int64, device=dev)
    done = torch.zeros(qn, dtype=torch.bool, device=dev)
    for shift, bits in ((21, 11), (10, 11), (0, 10)):
        top = (1 << bits) - 1
        match = (key & mask[:, None]) == prefix[:, None]
        digit = (key >> shift) & top
        hist = torch.zeros(qn, top + 1, dtype=torch.int64,
                           device=dev).scatter_add_(1, digit,
                                                    match.to(torch.int64))
        desc = hist.flip(1)                     # column i: digit top - i
        incl = desc.cumsum(1)
        pos = (incl < need[:, None]).sum(1)     # the bin holding the k-th
        above = (incl - desc).gather(1, pos[:, None])[:, 0]
        count = desc.gather(1, pos[:, None])[:, 0]
        live = ~done
        prefix = torch.where(live, prefix | ((top - pos) << shift), prefix)
        mask = torch.where(live, mask | (top << shift), mask)
        need = torch.where(live, need - above, need)
        done = done | (count == need)
    km = key & mask[:, None]
    gt = km > prefix[:, None]
    eq = km == prefix[:, None]
    eq_before = eq.cumsum(1) - eq.to(torch.int64)
    keep = gt | (eq & (eq_before < need[:, None]))
    cols = keep.nonzero()[:, 1].reshape(qn, k)
    return scores.gather(1, cols).float(), cols.to(torch.int32)


def ivf_scan_select_ref(q: torch.Tensor, corpus: torch.Tensor, k: int,
                        metric: str = "l2", n_valid: int = -1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel route in plain torch: scores, :func:`radix_select_ref`,
    then a stable sort of the k survivors -> (scores [Q, k], rows [Q, k]
    int32), equal to :func:`ivf_scan_topk_ref`."""
    if n_valid < 0 or n_valid > corpus.shape[0]:
        n_valid = corpus.shape[0]
    vals, rows = radix_select_ref(scores_ref(q, corpus, metric), n_valid, k)
    order_v, pos = stable_topk(vals, k)
    return order_v, torch.gather(rows, 1, pos)
