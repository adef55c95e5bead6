"""IVF scan wrapper: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.

The kernel (``csrc/ivf_scan.cu``) scores tiles of 256 rows and keeps each
tile's top-L (L = min(k, 256)) in ``lax.top_k`` order; a stable sort over
the [Q, n_tiles * L] candidates merges them.  Any k up to ``n_valid`` runs
the kernel: the reference's k <= 64 gate, which sent larger k to its XLA
twin, has no counterpart here.  The kernel masks its own ragged last tile,
so the corpus is never padded or copied; rows at or past ``n_valid`` never
reach the result.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref, normalize_rows
from repro_torch.kernels.topk import merge_tile_candidates

METRICS = ("l2", "ip", "cosine")

launches = LaunchCounter("ivf_scan")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ivf_scan_tile_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ivf_scan_tile_rows": [],
}


def ivf_scan_topk(q: torch.Tensor, corpus: torch.Tensor, k: int,
                  metric: str = "l2", n_valid: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, d] x [N, d] -> (vals [Q, k'] f32, rows [Q, k'] int32),
    k' = min(k, n_valid).

    Rows at positions >= ``n_valid`` (default: all of ``corpus``) are
    padding and never returned.  Ties go to the lower row."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    n = corpus.shape[0]
    if n_valid < 0 or n_valid > n:
        n_valid = n
    k = min(k, n_valid)
    if k <= 0:
        return (torch.zeros((q.shape[0], 0), dtype=torch.float32,
                            device=q.device),
                torch.zeros((q.shape[0], 0), dtype=torch.int32,
                            device=q.device))
    if q.device.type == "cpu" and corpus.device.type == "cpu":
        return ivf_scan_topk_ref(q, corpus, k, metric=metric, n_valid=n_valid)
    return _launch(q, corpus, k, metric, n_valid)


def _check(q: torch.Tensor, corpus: torch.Tensor) -> None:
    if not (q.is_cuda and corpus.is_cuda) or q.device != corpus.device:
        raise ValueError(f"ivf_scan: q on {q.device}, corpus on "
                         f"{corpus.device}; both must be on one CUDA device")
    for name, t in (("q", q), ("corpus", corpus)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"ivf_scan: {name} must be a contiguous 2-D "
                             f"float32 tensor, got {t.dtype} {tuple(t.shape)}")
    if q.shape[1] != corpus.shape[1]:
        raise ValueError(f"ivf_scan: q has d={q.shape[1]}, corpus "
                         f"d={corpus.shape[1]}")


def _launch(q: torch.Tensor, corpus: torch.Tensor, k: int, metric: str,
            n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(q, corpus)
    if metric == "cosine":
        q, corpus = normalize_rows(q), normalize_rows(corpus)
    qn, d = q.shape
    n = corpus.shape[0]
    lib = load("ivf_scan", _SIGNATURES)
    tile = lib.ivf_scan_tile_rows()
    topl = min(k, tile)
    width = -(-n // tile) * topl
    cand_v = torch.empty((qn, width), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((qn, width), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ivf_scan_tile_topk(
            q.data_ptr(), corpus.data_ptr(), cand_v.data_ptr(),
            cand_i.data_ptr(), qn, n, d, n_valid, topl, int(metric == "l2"),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("ivf_scan", err)
    launches.add()
    return merge_tile_candidates(cand_v, cand_i, k)
