"""IVF scan wrapper: the CUDA kernels for tensors on the card, the plain
version for tensors on the CPU.

``csrc/ivf_scan.cu`` scores every row (``ivf_score``, the [Q, N] scores in
scratch memory) and keeps each query's k rows (``radix_select`` of
``csrc/radix_select.cuh``, shared with the PQ scan and the merge: a radix
select of the k-th largest score, then the rows above it and the first rows
equal to it, in row order); a stable sort over those [Q, k] survivors puts
them in ``lax.top_k`` order.  No sort or top-k runs over all N columns.
Past ``SCRATCH_BYTES`` of scores the queries go in chunks.

With ``row_bucket`` and ``probe_mask`` (the index's dense probe scan) the
scoring kernel's masked instantiation sets row n of query q to -inf unless
``probe_mask[q, row_bucket[n]]`` is set; queries whose probed rows number
fewer than k get -inf values at the tail, on the rows that
``where(isfinite(vals), ...)`` maps to no id.

Any k up to ``n_valid`` runs the kernels: the reference's k <= 64 gate,
which sent larger k to its XLA twin, has no counterpart here.  The kernels
mask the ragged last tile, so the corpus is never padded or copied; rows at
or past ``n_valid`` never reach the result.

On a ``meta`` tensor it returns empty outputs of the kernels' shapes and
dtypes and runs neither the kernels nor the plain version.  While an
operation count runs (``launch/op_analysis.py``) a call on the card or on
meta records its function's ``work``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import sharded
from repro_torch.kernels.build import (LaunchCounter, check_launch,
                                      counting_work, load, record_work)
from repro_torch.kernels.ivf_scan.ref import ivf_scan_topk_ref, normalize_rows
from repro_torch.kernels.topk import sort_survivors

METRICS = ("l2", "ip", "cosine")

launches = LaunchCounter("ivf_scan")

#: most bytes of [Q, N] scores held at once; more queries go in chunks
SCRATCH_BYTES = 1 << 30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ivf_scan_scores": [_P, _P, _P, _P, _I, _I, _I, _L, _I, _P, _P, _I,
                        _P],
    "ivf_scan_select": [_P, _L, _I, _I, _I, _P, _P, _P],
}


def work(q: torch.Tensor, corpus: torch.Tensor, k: int
         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``ivf_scan_topk``: a multiply and an add for
    each query, corpus row and dimension; q and the corpus read once, the
    k (value, row) pairs of each query written once."""
    qn, d = q.shape
    n = corpus.shape[0]
    n_bytes = q.element_size() * qn * d + corpus.element_size() * n * d \
        + 8 * qn * k
    return 2.0 * qn * n * d, float(n_bytes)


def ivf_scan_topk(q: torch.Tensor, corpus: torch.Tensor, k: int,
                  metric: str = "l2", n_valid: int = -1,
                  row_bucket: Optional[torch.Tensor] = None,
                  probe_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[Q, d] x [N, d] -> (vals [Q, k'] f32, rows [Q, k'] int32),
    k' = min(k, n_valid).

    Rows at positions >= ``n_valid`` (default: all of ``corpus``) are
    padding and never returned.  Ties go to the lower row.  ``row_bucket``
    [N] int32 (each row's bucket, in [0, m)) and ``probe_mask`` [Q, m]
    uint8 or bool go together: row n scores -inf for query q unless
    ``probe_mask[q, row_bucket[n]]`` is set."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if (row_bucket is None) != (probe_mask is None):
        raise ValueError("ivf_scan: row_bucket and probe_mask go together")
    n = corpus.shape[0]
    if n_valid < 0 or n_valid > n:
        n_valid = n
    k = min(k, n_valid)
    if sharded.is_dtensor(q, corpus):
        if probe_mask is not None:
            raise ValueError("ivf_scan: no probe mask on DTensors")
        return _on_shards(q, corpus, k, metric, n_valid)
    if k <= 0:
        return (torch.zeros((q.shape[0], 0), dtype=torch.float32,
                            device=q.device),
                torch.zeros((q.shape[0], 0), dtype=torch.int32,
                            device=q.device))
    if q.device.type == "cpu" and corpus.device.type == "cpu":
        return ivf_scan_topk_ref(q, corpus, k, metric=metric, n_valid=n_valid,
                                 row_bucket=row_bucket, probe_mask=probe_mask)
    if counting_work():
        record_work("ivf_scan", work(q, corpus, k))
    if q.device.type == "meta":
        return (torch.empty((q.shape[0], k), dtype=torch.float32,
                            device="meta"),
                torch.empty((q.shape[0], k), dtype=torch.int32,
                            device="meta"))
    return _launch(q, corpus, k, metric, n_valid, row_bucket, probe_mask)


def _on_shards(q, corpus, k, metric, n_valid):
    """``ivf_scan_topk`` on DTensors: the corpus sharded by rows, each rank
    scans its rows with the kernel, and the ranks' (value, row) windows
    are all-gathered over the row-sharding mesh dims and merged in row
    order (the ``sharded_topk`` schedule of
    ``distributed/collectives.py``); q is gathered whole, the result is
    whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.topk import stable_topk

    mesh = (corpus if isinstance(corpus, DTensor) else q).device_mesh
    rep = [Replicate()] * mesh.ndim

    def dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, rep, run_check=False)
    q, corpus = sharded.keep_only(dt(q), ()), sharded.keep_only(dt(corpus),
                                                               (0,))
    first = sharded.offset(corpus, 0)
    local = corpus.to_local()
    n_local = max(0, min(local.shape[0], n_valid - first))
    k_local = min(k, n_local)
    vals, rows = ivf_scan_topk(q.to_local(), local, k_local, metric,
                               n_local)
    rows = rows.long() + first
    for i in reversed(sharded.sharded_over(corpus, 0)):
        vals = sharded.all_gather(vals, 1, mesh, i)
        rows = sharded.all_gather(rows, 1, mesh, i)
    vals, pos = stable_topk(vals, k)
    rows = torch.gather(rows, 1, pos).to(torch.int32)
    shape = (q.shape[0], k)
    return sharded.wrap(vals, q, rep, shape), sharded.wrap(rows, q, rep,
                                                           shape)


def _check(q: torch.Tensor, corpus: torch.Tensor,
           row_bucket: Optional[torch.Tensor],
           probe_mask: Optional[torch.Tensor]) -> None:
    tensors = [("q", q, torch.float32, 2), ("corpus", corpus, torch.float32,
                                            2)]
    if probe_mask is not None:
        tensors += [("row_bucket", row_bucket, torch.int32, 1),
                    ("probe_mask", probe_mask, torch.uint8, 2)]
    for name, t, dtype, dim in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"ivf_scan: {name} on {t.device}, q on "
                             f"{q.device}; all must be on one CUDA device")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"ivf_scan: {name} must be a contiguous {dim}-D "
                             f"{dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if q.shape[1] != corpus.shape[1]:
        raise ValueError(f"ivf_scan: q has d={q.shape[1]}, corpus "
                         f"d={corpus.shape[1]}")
    if probe_mask is not None and (
            row_bucket.shape[0] != corpus.shape[0]
            or probe_mask.shape[0] != q.shape[0] or probe_mask.shape[1] < 1):
        raise ValueError(f"ivf_scan: row_bucket {tuple(row_bucket.shape)} "
                         f"and probe_mask {tuple(probe_mask.shape)} do not "
                         f"fit q {tuple(q.shape)} and corpus "
                         f"{tuple(corpus.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ivf_scores(q: torch.Tensor, corpus: torch.Tensor, l2: bool,
               row_bucket: Optional[torch.Tensor] = None,
               probe_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``ivf_score``: [Q, d] x [N, d] -> scores [Q, ld] float32, ld
    = N rounded up to 4 (columns past N unset); with ``probe_mask`` (uint8
    [Q, m]) and ``row_bucket`` (int32 [N]) its masked instantiation."""
    qn, d = q.shape
    n = corpus.shape[0]
    ld = -(-n // 4) * 4
    scores = torch.empty((qn, ld), dtype=torch.float32, device=q.device)
    norms = torch.empty(qn + n, dtype=torch.float32, device=q.device)
    lib = load("ivf_scan", _SIGNATURES)
    with torch.cuda.device(q.device):
        masked = probe_mask is not None
        err = lib.ivf_scan_scores(
            q.data_ptr(), corpus.data_ptr(), scores.data_ptr(),
            norms.data_ptr(), qn, n, d, ld, int(l2),
            row_bucket.data_ptr() if masked else None,
            probe_mask.data_ptr() if masked else None,
            probe_mask.shape[1] if masked else 0, _stream(q))
    check_launch("ivf_scan scores", err)
    launches.add()
    return scores


def ivf_select(scores: torch.Tensor, n_valid: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``radix_select``: scores [Q, ld] -> each row's top-k among its
    first ``n_valid`` columns, in column order: (vals [Q, k] f32, cols
    [Q, k] int32)."""
    qn, ld = scores.shape
    vals = torch.empty((qn, k), dtype=torch.float32, device=scores.device)
    cols = torch.empty((qn, k), dtype=torch.int32, device=scores.device)
    lib = load("ivf_scan", _SIGNATURES)
    with torch.cuda.device(scores.device):
        err = lib.ivf_scan_select(scores.data_ptr(), ld, qn, n_valid, k,
                                  vals.data_ptr(), cols.data_ptr(),
                                  _stream(scores))
    check_launch("ivf_scan select", err)
    return vals, cols


def _launch(q: torch.Tensor, corpus: torch.Tensor, k: int, metric: str,
            n_valid: int, row_bucket: Optional[torch.Tensor],
            probe_mask: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if probe_mask is not None and probe_mask.dtype == torch.bool:
        probe_mask = probe_mask.view(torch.uint8)
    _check(q, corpus, row_bucket, probe_mask)
    if metric == "cosine":
        q, corpus = normalize_rows(q), normalize_rows(corpus)
    l2 = metric == "l2"
    step = max(1, SCRATCH_BYTES // (4 * (-(-corpus.shape[0] // 4) * 4)))
    parts = []
    for q0 in range(0, q.shape[0], step):
        scores = ivf_scores(q[q0:q0 + step], corpus, l2, row_bucket,
                            None if probe_mask is None
                            else probe_mask[q0:q0 + step])
        parts.append(sort_survivors(*ivf_select(scores, n_valid, k),
                                           k))
        del scores
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts]))
