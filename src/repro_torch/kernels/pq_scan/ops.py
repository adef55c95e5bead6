"""PQ ADC scan wrapper: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.

One CUDA kernel (``csrc/pq_scan.cu``) serves both of the reference's Pallas
kernels: the plain ADC scan and the extended one (``bias`` /
``row_bucket`` / ``cscores`` / ``probe_mask``: residual PQ and the fused
whole-table scan).  Each counts its own launches.  Any k up to ``n_valid``
runs the kernel: the reference's k <= 64 gate has no counterpart here.  The
kernel masks its own ragged last tile, so code tables are never padded.

With ``probe_mask``, queries whose probed buckets hold fewer than k rows
surface (val=-inf, id=-1) padding at the tail: the kernel pins non-probed
rows to NEG, and the wrapper turns NEG back into -inf, as the reference's
dispatcher does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.pq_scan.ref import pq_adc_topk_ref
from repro_torch.kernels.topk import merge_tile_candidates

_NEG_THRESH = -1.5e38  # kernel NEG mask values live below this

launches = LaunchCounter("pq_scan")
ext_launches = LaunchCounter("pq_scan_ext")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "pq_scan_tile_topk": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pq_scan_tile_rows": [],
}


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
    ext = bias is not None
    mb = 1
    ptrs = [0, 0, 0, 0]
    if ext:
        mb = cscores.shape[1]
        _check(bias, "bias", torch.float32, (n,), dev)
        _check(row_bucket, "row_bucket", torch.int32, (n,), dev)
        _check(cscores, "cscores", torch.float32, (qn, mb), dev)
        ptrs[:3] = [bias.data_ptr(), row_bucket.data_ptr(),
                    cscores.data_ptr()]
        if probe_mask is not None:
            _check(probe_mask, "probe_mask", torch.uint8, (qn, mb), dev)
            ptrs[3] = probe_mask.data_ptr()
    lib = load("pq_scan", _SIGNATURES)
    tile = lib.pq_scan_tile_rows()
    topl = min(k, tile)
    width = -(-n // tile) * topl
    cand_v = torch.empty((qn, width), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pq_scan_tile_topk(
            luts.data_ptr(), codes.data_ptr(), *ptrs, cand_v.data_ptr(),
            cand_i.data_ptr(), qn, n, m, ksub, mb, n_valid, topl, int(ext),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch("pq_scan_ext" if ext else "pq_scan", err)
    (ext_launches if ext else launches).add()
    return merge_tile_candidates(cand_v, cand_i, k)
