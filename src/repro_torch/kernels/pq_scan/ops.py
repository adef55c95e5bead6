"""PQ ADC scan wrapper: the CUDA kernels for tensors on the card, the plain
version for tensors on the CPU.

One CUDA scoring kernel (``csrc/pq_scan.cu``, ``pq_score``) serves both of
the reference's Pallas kernels: the plain ADC scan and the extended one
(``bias`` / ``row_bucket`` / ``cscores`` / ``probe_mask``: residual PQ and
the fused whole-table scan).  It writes the [Q, n_valid] scores to scratch
memory; ``pq_scan_select`` (the radix selection of
``csrc/radix_select.cuh``) keeps each query's k rows in row order (with few
queries, each segment's k: ``select_segments``), and a stable sort over
those survivors puts them in ``lax.top_k`` order.  No sort or top-k runs
over all N columns.  Past ``SCRATCH_BYTES`` of scores the queries go in
chunks, each one scoring launch, counted by the form it serves.  Any k up
to ``n_valid`` runs the kernels: the reference's k <= 64 gate has no
counterpart here.  Code tables are never padded or copied.

With ``probe_mask``, queries whose probed buckets hold fewer than k rows
surface (val=-inf, id=-1) padding at the tail: the kernel pins non-probed
rows to NEG, and the wrapper turns NEG back into -inf, as the reference's
dispatcher does.

On a ``meta`` tensor it returns empty outputs of the kernels' shapes and
dtypes and runs neither the kernels nor the plain version.  While an
operation count runs (``launch/op_analysis.py``) a call on the card or on
meta records its function's ``work``, under its form's name.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check_launch,
                                      counting_work, load, record_work)
from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref
from repro_torch.kernels.topk import sort_survivors

_NEG_THRESH = -1.5e38  # kernel NEG mask values live below this

launches = LaunchCounter("pq_scan")
ext_launches = LaunchCounter("pq_scan_ext")

#: most bytes of [Q, N] scores held at once; more queries go in chunks
SCRATCH_BYTES = 1 << 30
#: blocks the selection aims for: with fewer queries each row is cut into
#: segments of at least MIN_SEGMENT columns, selected by a block each (a
#: probe group of the adc path holds a few queries over 100,000s of rows)
SELECT_BLOCKS = 256
MIN_SEGMENT = 16384

#: shared memory a scoring block may stage LUTs in (bytes; the H100's 227 KB)
SMEM_MAX = 227 * 1024

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pq_scan_scores": [_P, _P, _P, _P, _P, _P, _P, _L,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    "pq_scan_select": [_P, _L, _I, _I, _I, _I, _P, _P, _P],
}


def work(luts: torch.Tensor, codes: torch.Tensor, k: int, n_valid: int,
         cscores: Optional[torch.Tensor] = None,
         probe_mask: Optional[torch.Tensor] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``pq_adc_topk`` over ``n_valid`` rows: an add
    for each query, row and subspace (the extended form: two more a query
    and row, its bias and bucket terms); the LUTs and the rows' codes read
    once, the k (value, row) pairs of each query written once (the
    extended form: 8 B a row of bias and bucket, and each query's bucket
    terms, plus a mask byte each under ``probe_mask``)."""
    qn, m, ksub = luts.shape
    n_bytes = luts.element_size() * qn * m * ksub \
        + codes.element_size() * n_valid * m + 8 * qn * k
    flops = float(qn) * n_valid * m
    if cscores is not None or probe_mask is not None:
        buckets = (cscores if cscores is not None else probe_mask).shape[1]
        n_bytes += 8 * n_valid + qn * buckets * (
            4 if probe_mask is None else 5)
        flops += 2.0 * qn * n_valid
    return flops, float(n_bytes)


def pq_adc_topk(luts: torch.Tensor, codes: torch.Tensor, k: int,
                n_valid: int = -1,
                bias: Optional[torch.Tensor] = None,
                row_bucket: Optional[torch.Tensor] = None,
                cscores: Optional[torch.Tensor] = None,
                probe_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, M, K] x [N, M] -> (vals [Q, k'] f32, rows [Q, k'] int32),
    k' = min(k, n_valid).

    Rows at positions >= ``n_valid`` (default: all of ``codes``) are
    padding and never returned.  ``cscores`` / ``probe_mask`` require
    ``row_bucket``; with ``probe_mask``, per-query positions past that
    query's probed row count come back as (val=-inf, id=-1)."""
    n = codes.shape[0]
    qn = luts.shape[0]
    if n_valid < 0 or n_valid > n:
        n_valid = n
    k = min(k, n_valid)
    dev = luts.device
    if k <= 0:
        return (torch.zeros((qn, 0), dtype=torch.float32, device=dev),
                torch.zeros((qn, 0), dtype=torch.int32, device=dev))
    ext = any(a is not None for a in (bias, row_bucket, cscores, probe_mask))
    if (cscores is not None or probe_mask is not None) and row_bucket is None:
        raise ValueError("cscores/probe_mask require row_bucket")
    if ext:
        # the reference dispatcher's zero defaults: the adds happen either
        # way, so kernel and plain version round alike
        mb = (cscores.shape[1] if cscores is not None
              else probe_mask.shape[1] if probe_mask is not None else 1)
        if bias is None:
            bias = torch.zeros(n, dtype=torch.float32, device=codes.device)
        if row_bucket is None:
            row_bucket = torch.zeros(n, dtype=torch.int32,
                                     device=codes.device)
        if cscores is None:
            cscores = torch.zeros((qn, mb), dtype=torch.float32, device=dev)
    tensors = [luts, codes] + ([bias, row_bucket, cscores] if ext else []) \
        + ([probe_mask] if probe_mask is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return pq_adc_topk_ref(luts, codes, k, n_valid=n_valid, bias=bias,
                               row_bucket=row_bucket, cscores=cscores,
                               probe_mask=probe_mask)
    if counting_work():
        record_work("pq_scan_ext" if ext else "pq_scan",
                    work(luts, codes, k, n_valid, cscores if ext else None,
                         probe_mask))
    if luts.device.type == "meta":
        return (torch.empty((qn, k), dtype=torch.float32, device="meta"),
                torch.empty((qn, k), dtype=torch.int32, device="meta"))
    if ext:
        if probe_mask is not None and probe_mask.dtype == torch.bool:
            probe_mask = probe_mask.view(torch.uint8)
        v, i = _launch(luts, codes, k, n_valid, bias, row_bucket, cscores,
                       probe_mask)
        if probe_mask is not None:
            v = torch.where(v <= _NEG_THRESH, -torch.inf, v)
            i = torch.where(torch.isfinite(v), i, -1)
        return v, i
    return _launch(luts, codes, k, n_valid)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"pq_scan: {name} is on {t.device}, expected "
                         f"{device} (all inputs on one CUDA device)")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"pq_scan: {name} must be a contiguous {dtype} "
                         f"tensor of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pq_scores(luts: torch.Tensor, codes: torch.Tensor, n_valid: int,
              bias: Optional[torch.Tensor] = None,
              row_bucket: Optional[torch.Tensor] = None,
              cscores: Optional[torch.Tensor] = None,
              probe_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``pq_score`` (the extended form when ``bias`` is given, then
    with ``row_bucket`` and ``cscores``; ``probe_mask`` uint8 or None):
    [Q, M, K] x [N, M] -> scores [Q, ld] float32, ld = ``n_valid`` rounded
    up to 4 (columns past ``n_valid`` unset; non-probed rows NEG).  A block
    scores :func:`query_slots` queries."""
    qn, m, ksub = luts.shape
    ext = bias is not None
    mb = cscores.shape[1] if ext else 1
    ld = -(-n_valid // 4) * 4
    scores = torch.empty((qn, ld), dtype=torch.float32, device=luts.device)
    ptrs = ([bias.data_ptr(), row_bucket.data_ptr(), cscores.data_ptr(),
             0 if probe_mask is None else probe_mask.data_ptr()]
            if ext else [0, 0, 0, 0])
    lib = load("pq_scan", _SIGNATURES)
    with torch.cuda.device(luts.device):
        err = lib.pq_scan_scores(luts.data_ptr(), codes.data_ptr(), *ptrs,
                                 scores.data_ptr(), ld, qn, n_valid, m, ksub,
                                 mb, int(ext), query_slots(qn, m, ksub),
                                 _stream(luts))
    check_launch("pq_scan_ext" if ext else "pq_scan", err)
    (ext_launches if ext else launches).add()
    return scores


def query_slots(qn: int, m: int, ksub: int) -> int:
    """Queries a scoring block stages the LUTs of: 4 (one float4 an
    interleaved entry) where four LUTs fit SMEM_MAX and there are more than
    6 queries, else 1.  On an H100 at 800,000 rows one slot scores faster
    up to 6 queries (fewer blocks idle on empty slots), four from 7 on."""
    per_q = 4 * m * ksub
    if per_q > SMEM_MAX:
        raise ValueError(f"pq_scan: a [{m}, {ksub}] LUT ({per_q} bytes) "
                         f"does not fit {SMEM_MAX} bytes of shared memory")
    return 4 if qn > 6 and 4 * per_q <= SMEM_MAX else 1


def select_segments(qn: int, n_valid: int, k: int) -> int:
    """Segments each of ``qn`` rows is cut into for the selection: enough
    for SELECT_BLOCKS blocks, each of at least MIN_SEGMENT and k + 3
    columns (a segment of n_valid // n_seg rounded down to 4 keeps k)."""
    if qn >= SELECT_BLOCKS:
        return 1
    return max(1, min(-(-SELECT_BLOCKS // qn),
                      n_valid // max(k + 3, MIN_SEGMENT)))


def pq_select(scores: torch.Tensor, n_valid: int, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``pq_scan_select``: scores [Q, ld] -> the top-k among the
    first ``n_valid`` columns of each row's :func:`select_segments`
    segments, in row order: (vals [Q, n_seg * k] f32, rows [Q, n_seg * k]
    int32), which hold each row's top-k."""
    qn, ld = scores.shape
    n_seg = select_segments(qn, n_valid, k)
    vals = torch.empty((qn, n_seg * k), dtype=torch.float32,
                       device=scores.device)
    rows = torch.empty((qn, n_seg * k), dtype=torch.int32,
                       device=scores.device)
    lib = load("pq_scan", _SIGNATURES)
    with torch.cuda.device(scores.device):
        err = lib.pq_scan_select(scores.data_ptr(), ld, qn, n_valid, k,
                                 n_seg, vals.data_ptr(), rows.data_ptr(),
                                 _stream(scores))
    check_launch("pq_scan select", err)
    return vals, rows


def _launch(luts: torch.Tensor, codes: torch.Tensor, k: int, n_valid: int,
            bias: Optional[torch.Tensor] = None,
            row_bucket: Optional[torch.Tensor] = None,
            cscores: Optional[torch.Tensor] = None,
            probe_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = luts.device
    qn, m, ksub = luts.shape
    n = codes.shape[0]
    _check(luts, "luts", torch.float32, (qn, m, ksub), dev)
    _check(codes, "codes", torch.uint8, (n, m), dev)
    if bias is not None:
        mb = cscores.shape[1]
        _check(bias, "bias", torch.float32, (n,), dev)
        _check(row_bucket, "row_bucket", torch.int32, (n,), dev)
        _check(cscores, "cscores", torch.float32, (qn, mb), dev)
        if probe_mask is not None:
            _check(probe_mask, "probe_mask", torch.uint8, (qn, mb), dev)
    step = max(1, SCRATCH_BYTES // (4 * (-(-n_valid // 4) * 4)))
    parts = []
    for q0 in range(0, qn, step):
        part = slice(q0, q0 + step)
        scores = pq_scores(
            luts[part], codes, n_valid, bias, row_bucket,
            None if cscores is None else cscores[part],
            None if probe_mask is None else probe_mask[part])
        parts.append(sort_survivors(*pq_select(scores, n_valid, k), k))
        del scores
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts]))
