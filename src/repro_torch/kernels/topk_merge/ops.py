"""k-way top-k merge wrapper: the CUDA kernels for tensors on the card, the
plain version for tensors on the CPU.

The kernels (``csrc/topk_merge.cu``) read the [P, Q, K] shard windows in
place, clamp (-inf, -1) padding up to ``CLAMP`` so each padding column is
taken exactly once, lower column first, and never choose columns >=
``n_valid``.  Windows of at most ``SMALL_COLS`` columns (the cluster
kNN's: P = 4 shards of k = 10 or 100) take one launch,
``topk_merge_small``: a bitonic sort of each query's columns in shared
memory that writes the k values, -inf restored, and gathers their ids from
the windows.  Wider windows (large k) take the radix selection of ``csrc/radix_select.cuh`` (k survivors in column order),
a stable sort over those [Q, k] survivors, and ``topk_merge_epilogue``,
which restores -inf and gathers the ids.  Ids are int64 or int32, copied as
raw bits.  Any k up to ``n_valid`` runs the kernels: the reference's
k <= 64 gate, which sent larger k to its XLA twin, has no counterpart here.

On a ``meta`` tensor it returns empty outputs of the kernels' shapes and
dtypes and runs neither the kernels nor the plain version.  While an
operation count runs (``launch/op_analysis.py``) a call on the card or on
meta records its function's ``work``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check_launch,
                                      counting_work, load, record_work)
from repro_torch.kernels.topk_merge.ref import merge_topk_ref

#: widest window (P * K columns) of the one-launch path; the kernel takes
#: at most 512
SMALL_COLS = 512

launches = LaunchCounter("topk_merge")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "topk_merge_small": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    "topk_merge_select": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "topk_merge_epilogue": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
}


def work(vals: torch.Tensor, ids: torch.Tensor, k: int
         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``merge_topk_dev``: no arithmetic; the
    windows' values read once, the ids of the k chosen columns read and
    each query's k (value, id) pairs written once."""
    p, qn, kk = vals.shape
    n_bytes = vals.element_size() * qn * p * kk \
        + ids.element_size() * qn * k + (4 + ids.element_size()) * qn * k
    return 0.0, float(n_bytes)


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
    if counting_work():
        record_work("topk_merge", work(vals, ids, k))
    if vals.device.type == "meta":
        return (torch.empty((qn, k), dtype=torch.float32, device="meta"),
                torch.empty((qn, k), dtype=ids.dtype, device="meta"))
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
    if ids.element_size() not in (4, 8):
        raise ValueError(f"topk_merge: ids must be 4- or 8-byte integers, "
                         f"got {ids.dtype}")


def _launch(vals: torch.Tensor, ids: torch.Tensor, k: int, n_valid: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(vals, ids)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    p, qn, kk = vals.shape
    dev = vals.device
    lib = load("topk_merge", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out_i = torch.empty((qn, k), dtype=ids.dtype, device=dev)
    if p * kk <= SMALL_COLS:
        out_v = torch.empty((qn, k), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.topk_merge_small(vals.data_ptr(), ids.data_ptr(),
                                       ids.element_size(), out_v.data_ptr(),
                                       out_i.data_ptr(), p, qn, kk, n_valid,
                                       k, stream)
        check_launch("topk_merge", err)
        launches.add()
        return out_v, out_i
    sel_v, sel_c = merge_select(vals, k, n_valid)
    out_v, pos = torch.sort(sel_v, dim=1, descending=True, stable=True)
    merge_epilogue(out_v, pos, sel_c, ids, out_i)
    return out_v, out_i


def merge_select(vals: torch.Tensor, k: int, n_valid: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``radix_select`` over the clamped columns of the [P, Q, K]
    windows: each query's top-k among its first ``n_valid`` columns, in
    column order (vals [Q, k] f32, columns [Q, k] int32).  Counts the
    merge's launch."""
    p, qn, kk = vals.shape
    sel_v = torch.empty((qn, k), dtype=torch.float32, device=vals.device)
    sel_c = torch.empty((qn, k), dtype=torch.int32, device=vals.device)
    lib = load("topk_merge", _SIGNATURES)
    with torch.cuda.device(vals.device):
        err = lib.topk_merge_select(
            vals.data_ptr(), sel_v.data_ptr(), sel_c.data_ptr(), p, qn, kk,
            n_valid, k, torch.cuda.current_stream(vals.device).cuda_stream)
    check_launch("topk_merge select", err)
    launches.add()
    return sel_v, sel_c


def merge_epilogue(out_v: torch.Tensor, pos: torch.Tensor,
                   sel_c: torch.Tensor, ids: torch.Tensor,
                   out_i: torch.Tensor) -> None:
    """Kernel ``merge_epilogue``: ``out_v`` [Q, k], the survivors' values
    after a stable descending sort whose int64 permutation is ``pos``, gets
    -inf restored in place; ``out_i`` [Q, k] the ids of the columns
    ``sel_c[q, pos[q, j]]`` from the [P, Q, K] windows ``ids``."""
    qn, k = out_v.shape
    lib = load("topk_merge", _SIGNATURES)
    with torch.cuda.device(out_v.device):
        err = lib.topk_merge_epilogue(
            out_v.data_ptr(), pos.data_ptr(), sel_c.data_ptr(),
            ids.data_ptr(), ids.element_size(), out_i.data_ptr(), qn,
            ids.shape[2], k,
            torch.cuda.current_stream(out_v.device).cuda_stream)
    check_launch("topk_merge epilogue", err)
