"""Top-k in the reference's order: descending score, ties to the lower index.

``jax.lax.top_k`` breaks ties by index and ``torch.topk`` does not, so every
top-k of the port goes through a stable descending sort.  The scan and
merge kernels select by radix select (``csrc/radix_select.cuh``): they leave
each query's k survivors in column order, so a stable sort over those
[Q, k] survivors alone (:func:`sort_survivors`) puts them in the global
order.  :func:`radix_select_ref` is that selection in plain torch, which
the CPU tests of all three kernels share."""
from __future__ import annotations

from typing import Tuple

import torch


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Top-``k`` of each row of ``scores`` [Q, N]: (values, int64 columns)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def sort_survivors(vals: torch.Tensor, cols: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Epilogue of the scans: the [Q, C] (value, column) survivors of a
    selection, in column order -> top-``k`` in ``lax.top_k`` order (vals
    f32, the columns' dtype).  A stable sort keeps the lower column first
    among equal values."""
    vals, pos = stable_topk(vals, k)
    return vals, torch.gather(cols, 1, pos)


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """float32 scores -> int64 keys in [0, 2**32) in the scores' order, as
    ``radix_select.cuh`` forms them (-0 and +0 get one key)."""
    u = scores.float().contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def radix_select_ref(scores: torch.Tensor, n_valid: int, k: int,
                     n_seg: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``radix_select.cuh`` computes, in plain torch: per row of scores
    [Q, >= n_valid], its top-``k`` among the first ``n_valid`` columns, in
    column order: (vals [Q, k] f32, cols [Q, k] int32).  With ``n_seg`` > 1
    the columns are cut into segments of ``n_valid // n_seg`` rounded down
    to 4 (the last up to ``n_valid``) and each segment's top-``k`` comes
    out, segment after segment: [Q, n_seg * k].

    Three digit passes over the order keys (11, 11 and 10 bits, most
    significant first) find the digits of the k-th largest key: a pass
    histograms the keys that match the digits chosen so far and picks the
    digit whose bin holds the k-th; a row stops once that bin holds exactly
    the keys still needed.  Then every key above the threshold is kept, and
    of the keys equal to it the first in column order (``lax.top_k``'s tie
    rule)."""
    if n_seg > 1:
        seg = n_valid // n_seg // 4 * 4
        parts = [radix_select_ref(scores[:, s * seg:], n_valid - s * seg
                                  if s == n_seg - 1 else seg, k)
                 for s in range(n_seg)]
        return (torch.cat([v for v, _ in parts], 1),
                torch.cat([c + s * seg for s, (_, c) in enumerate(parts)], 1))
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
