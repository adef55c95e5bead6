"""k-way top-k merge wrapper: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU.

The kernel (``csrc/topk_merge.cu``) reads the [P, Q, K] shard windows in
place, clamps (-inf, -1) padding up to ``CLAMP`` so each padding column is
taken exactly once, lower column first, pins columns >= ``n_valid`` below
it, and keeps each tile's top-L (L = min(k, tile width)) as a sorted run in
``lax.top_k`` order.  A window of at most 256 columns is one tile, whose
first k are the answer; wider windows (large k) merge their runs pairwise
on the card until one run of k is left.  The wrapper then gathers the id
payloads by column and restores -inf.  Any k up to ``n_valid`` runs the
kernel: the reference's k <= 64 gate, which sent larger k to its XLA twin,
has no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.topk_merge.ref import merge_topk_ref

CLAMP = -1.0e38   # the kernel's input floor: values at or below it are padding

launches = LaunchCounter("topk_merge")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "topk_merge": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "topk_merge_work_cols": [_I, _I],
}


def merge_topk_dev(vals: torch.Tensor, ids: torch.Tensor, k: int,
                   n_valid: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, Q, K] x [P, Q, K] -> (vals [Q, k'] f32, ids [Q, k']),
    k' = min(k, n_valid).

    Flattened candidate columns at positions >= ``n_valid`` (default: all
    C = P*K of them) are padding and never chosen; column p*K + j is shard
    p's rank-j candidate.  (-inf, -1) padding *within* the windows sinks
    below every real candidate and surfaces in ascending column order, so
    the merged prefix is always the real global top-k."""
    p, qn, kk = vals.shape
    c = p * kk
    if n_valid < 0 or n_valid > c:
        n_valid = c
    k = min(k, n_valid)
    if k <= 0:
        return (torch.zeros((qn, 0), dtype=torch.float32, device=vals.device),
                torch.zeros((qn, 0), dtype=ids.dtype, device=ids.device))
    if vals.device.type == "cpu" and ids.device.type == "cpu":
        return merge_topk_ref(vals, ids, k, n_valid=n_valid)
    return _launch(vals, ids, k, n_valid)


def _check(vals: torch.Tensor, ids: torch.Tensor) -> None:
    if not (vals.is_cuda and ids.is_cuda) or vals.device != ids.device:
        raise ValueError(f"topk_merge: vals on {vals.device}, ids on "
                         f"{ids.device}; both must be on one CUDA device")
    if vals.dtype != torch.float32 or vals.dim() != 3 \
            or not vals.is_contiguous():
        raise ValueError(f"topk_merge: vals must be a contiguous 3-D float32 "
                         f"tensor, got {vals.dtype} {tuple(vals.shape)}")
    if ids.shape != vals.shape:
        raise ValueError(f"topk_merge: ids {tuple(ids.shape)} and vals "
                         f"{tuple(vals.shape)} differ in shape")


def _launch(vals: torch.Tensor, ids: torch.Tensor, k: int, n_valid: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(vals, ids)
    p, qn, kk = vals.shape
    lib = load("topk_merge", _SIGNATURES)
    # two buffers of sorted runs that the pairwise merges ping-pong between
    work = lib.topk_merge_work_cols(p * kk, k)
    work_v = torch.empty((2, qn, work), dtype=torch.float32,
                         device=vals.device)
    work_c = torch.empty((2, qn, work), dtype=torch.int32, device=vals.device)
    out_v = torch.empty((qn, k), dtype=torch.float32, device=vals.device)
    out_c = torch.empty((qn, k), dtype=torch.int32, device=vals.device)
    with torch.cuda.device(vals.device):
        err = lib.topk_merge(
            vals.data_ptr(), out_v.data_ptr(), out_c.data_ptr(),
            work_v.data_ptr(), work_c.data_ptr(), p, qn, kk, n_valid, k,
            torch.cuda.current_stream(vals.device).cuda_stream)
    check_launch("topk_merge", err)
    launches.add()
    return gather_ids(out_v, out_c, ids)


def gather_ids(mv: torch.Tensor, cols: torch.Tensor, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's epilogue: the merged [Q, k] (value, column) pairs ->
    values with -inf restored and the id payloads of their columns,
    gathered from the [P, Q, K] windows in place."""
    p, qn, kk = ids.shape
    # column c = p*K + j is ids[p, q, j]
    cols = cols.to(torch.int64)
    shard = torch.div(cols, kk, rounding_mode="floor")
    rows = torch.arange(qn, device=ids.device)[:, None]
    picked = ids.reshape(-1)[(shard * qn + rows) * kk + (cols - shard * kk)]
    return torch.where(mv <= CLAMP, -torch.inf, mv), picked
