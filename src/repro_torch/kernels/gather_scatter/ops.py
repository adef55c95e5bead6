"""The GNN's SpMM wrapper: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.

``gather_scatter(x, src, dst, n_nodes, edge_weight, reduce)`` computes
``out[v] = reduce_{e: dst[e] = v} w[e] * x[src[e]]`` for ``reduce`` "sum"
or "mean" (the mean divides by every edge into v, masked ones too).  On
the card the kernel (``csrc/gather_scatter.cu``) reads the edges as a CSR
by destination, in the order of a stable sort, and sums each row in
registers: no [E, d] message tensor is built.  :class:`EdgeCSR` holds that
CSR, and the CSR by source that the gradient runs on, each with the list
of its long rows (``long_row_min``: 16 times the mean row, at most
``LONG_ROW`` = 1,024 edges), which the kernel takes first and splits by
columns; build it once for a graph (``EdgeCSR.build``; ``EdgeCSR.regular``
for edges already in destination order, a fixed number a row, as an
embedding bag's ids) and pass it to every call on that graph, forward and
backward, instead of sorting the edges a call.  Nothing here waits for the card.

The gradient is a ``torch.autograd.Function``: d x is the same kernel over
the CSR by source; for the mean the kernel divides each edge's weight by
the count of its destination itself.  No caller needs the weights'
gradient, so weights that require one raise.  Every call with a CUDA ``x``
launches the kernel: there is no size gate and no fallback.

On a ``meta`` ``x`` the call, and its gradient, return empty outputs of
the kernel's shapes and dtypes: no CSR is built and neither the kernel nor
the plain version runs.  While an operation count runs
(``launch/op_analysis.py``) each forward and gradient on the card or on
meta records its function's ``work``.

On ``DTensor``s the kernel runs on each rank's edges (``_on_shards``):
the edges may be sharded, x is gathered whole on the mesh dims that shard
them (explicitly) and may stay sharded by features elsewhere; the sum
over a rank's edges is a partial sum over the edge-sharding mesh dims.
There a mean is that sum over the count of every edge into the row, both
reduced before the division; on a mesh that does not split the edges the
kernel's own mean runs, as on plain tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import sharded
from repro_torch.kernels.build import (LaunchCounter, check_launch,
                                      counting_work, load, record_work)
from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref

launches = LaunchCounter("gather_scatter")

#: rows of this many edges are always long: the kernel takes long rows
#: before the others and splits their columns over warps
LONG_ROW = 1024


def long_row_min(n_edges: int, n_rows: int) -> int:
    """The fewest edges of a long row: 16 times the mean row (taken as at
    least 4 edges), at most LONG_ROW.  Set from measurement: at
    ogb_products' mean of 25 a threshold of 64 slows the backward, 256 and
    1,024 do not; on Cora (mean 4) the row of 196 padding edges, walked
    whole by one warp a tile, doubles the forward's time unless it is long
    (64)."""
    mean = -(-n_edges // max(n_rows, 1))
    return min(LONG_ROW, 16 * max(4, mean))


def work(x_rows: int, n_out: int, d: int, n_edges: int, x_bytes: int,
         out_bytes: int, *, weighted: bool, ptr_rows: int,
         mean: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one SpMM ``out[v] = reduce w[e] x[src[e]]`` (or
    its gradient, the same sum over the reversed edges): ``x_rows`` rows of
    d values of x read once (all of x, unless the caller knows the rows
    its edges touch), the [n_out, d] output written once, 4 B an edge for
    its column and 4 more for its weight, and the row pointer, 8 B a row
    of ``ptr_rows`` plus one (0: the rows are implied, as a bag's fixed
    count); a multiply-add an edge and column (an add unweighted), and the
    mean's scale a multiply an output value."""
    flops = float(n_edges) * d * (2 if weighted else 1) \
        + (float(n_out) * d if mean else 0.0)
    n_bytes = x_rows * d * x_bytes + n_out * d * out_bytes \
        + (8 if weighted else 4) * n_edges \
        + (8 * (ptr_rows + 1) if ptr_rows else 0)
    return flops, float(n_bytes)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"gather_scatter": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                  _P, _I, _L, _I, _I, _P]}


def _csr(key: torch.Tensor, other: torch.Tensor, n: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ptr [n + 1] int64, perm [E] int64, col [E] int32): the edges in the
    order of a stable sort by ``key``, ``col = other[perm]``; ``ptr[v]``,
    the edges with a key below v, by a search of the sorted keys."""
    keys, perm = torch.sort(key, stable=True)
    ptr = torch.searchsorted(
        keys, torch.arange(n + 1, dtype=keys.dtype, device=key.device))
    return ptr, perm, other[perm].to(torch.int32)


@dataclasses.dataclass
class RowCSR:
    """One CSR as the kernel reads it: ``ptr`` [n + 1] int64, ``perm`` [E]
    int64 (the edges' order), ``col`` [E] int32, and ``long_rows`` int32,
    whose first ``n_long`` (one int32 on the edges' device) entries are the
    rows of at least ``long_min`` (``long_row_min``) edges, in index
    order; ``count`` [n] int64, each row's edges; ``work``, the kernel's
    work counter (one int64, 0 between launches: the launches over one
    CSR run on one stream)."""

    ptr: torch.Tensor
    perm: torch.Tensor
    col: torch.Tensor
    count: torch.Tensor
    long_rows: torch.Tensor
    n_long: torch.Tensor
    long_min: int
    work: torch.Tensor

    @staticmethod
    def build(key: torch.Tensor, other: torch.Tensor, n: int) -> "RowCSR":
        """The CSR of edges ``other[e] -> key[e]`` over ``n`` rows, its rows
        of at least ``long_row_min`` edges listed by a cumulative sum and a
        scatter: no host sync."""
        return RowCSR.of(*_csr(key, other, n))

    @staticmethod
    def of(ptr: torch.Tensor, perm: torch.Tensor, col: torch.Tensor
           ) -> "RowCSR":
        """The CSR of ``ptr``, ``perm`` and ``col`` (as :meth:`build` makes
        them), with its long rows' list."""
        n, dev = ptr.numel() - 1, ptr.device
        long_min = long_row_min(col.numel(), n)
        count = ptr[1:] - ptr[:-1]
        is_long = count >= long_min
        # at most E // long_min rows are long; the last slot takes the rest
        cap = min(n, col.numel() // long_min) + 1
        pos = torch.cumsum(is_long, 0)
        slot = torch.where(is_long, pos - 1, cap - 1)
        rows = torch.zeros(cap, dtype=torch.int32, device=dev)
        rows.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                            device=dev))
        n_long = (pos[-1:] if n else torch.zeros(1, dtype=torch.int64,
                                                 device=dev))
        return RowCSR(ptr, perm, col, count, rows, n_long.to(torch.int32),
                      long_min, torch.zeros(1, dtype=torch.int64,
                                            device=dev))


@dataclasses.dataclass
class EdgeCSR:
    """The edges ``src -> dst`` of one graph as the kernel reads them: by
    destination (``rows``; ``count`` [n_nodes] float32, the edges into each
    node), and, built at the first backward, by source (``transposed()``)
    over ``n_src`` rows.  ``uniform``: every row holds the same number of
    edges (:meth:`regular`)."""

    n_nodes: int
    n_src: int
    src: torch.Tensor
    dst: torch.Tensor
    rows: RowCSR
    count: torch.Tensor
    rows_t: Optional[RowCSR] = None
    uniform: bool = False

    @staticmethod
    def build(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              n_src: Optional[int] = None) -> "EdgeCSR":
        """The CSR by destination of edges ``src[e] -> dst[e]`` (``n_src``,
        the rows of ``x``, defaults to ``n_nodes``): one stable
        ``torch.sort``, a ``searchsorted`` and the long rows' list on the
        edges' device."""
        if src.shape != dst.shape or src.dim() != 1:
            raise ValueError(f"EdgeCSR: src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} must be one 1-D shape")
        rows = RowCSR.build(dst, src, n_nodes)
        return EdgeCSR(n_nodes, n_nodes if n_src is None else n_src, src,
                       dst, rows, rows.count.to(torch.float32))

    @staticmethod
    def regular(src: torch.Tensor, per_row: int,
                n_src: int) -> "EdgeCSR":
        """The CSR of edges already in destination order, ``per_row`` into
        each row: edge e runs ``src[e] -> e // per_row`` (an embedding
        bag's ids).  Equal to :meth:`build`'s for those edges, with no
        sort: ``ptr`` is ``per_row`` times the row, ``perm`` the edges'
        own order."""
        if src.dim() != 1 or per_row < 1 or src.numel() % per_row:
            raise ValueError(f"EdgeCSR.regular: {tuple(src.shape)} edges do "
                             f"not split into rows of {per_row}")
        e, dev = src.numel(), src.device
        n = e // per_row
        ptr = torch.arange(n + 1, dtype=torch.int64, device=dev) * per_row
        perm = torch.arange(e, dtype=torch.int64, device=dev)
        dst = torch.div(perm, per_row, rounding_mode="floor").to(
            torch.int32)
        rows = RowCSR.of(ptr, perm, src.to(torch.int32))
        return EdgeCSR(n, n_src, src, dst, rows, rows.count.to(torch.float32),
                       uniform=True)

    def transposed(self) -> RowCSR:
        """The CSR by source, built once."""
        if self.rows_t is None:
            self.rows_t = RowCSR.build(self.src, self.dst, self.n_src)
        return self.rows_t


def gather_scatter(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n_nodes: int, edge_weight: Optional[torch.Tensor] = None,
                   reduce: str = "sum", csr: Optional[EdgeCSR] = None
                   ) -> torch.Tensor:
    """out[v] = reduce_{e: dst[e] = v} w[e] * x[src[e]] ("sum" or "mean"):
    [n_nodes, *x.shape[1:]], in the type of ``x * w``.  ``csr``: the
    graph's :class:`EdgeCSR` (built here if not given; ignored on the
    CPU)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"gather_scatter: reduce {reduce!r} is not sum or "
                         f"mean")
    if sharded.is_dtensor(x, src, dst, edge_weight):
        return _on_shards(x, src, dst, n_nodes, edge_weight, reduce)
    if x.device.type == "cpu":
        return gather_scatter_ref(x, src, dst, n_nodes, edge_weight, reduce)
    if edge_weight is not None and edge_weight.requires_grad:
        raise ValueError("gather_scatter: the kernel gives no gradient for "
                         "the edge weights")
    if x.device.type == "meta":
        return _MetaGatherScatter.apply(x, edge_weight, n_nodes, src.numel(),
                                        reduce == "mean",
                                        csr is not None and csr.uniform)
    if csr is None:
        csr = EdgeCSR.build(src, dst, n_nodes, x.shape[0])
    if csr.n_nodes != n_nodes or csr.n_src != x.shape[0] \
            or csr.rows.col.numel() != src.numel():
        raise ValueError(f"gather_scatter: the CSR is of "
                         f"{csr.rows.col.numel()} edges {csr.n_src} -> "
                         f"{csr.n_nodes} rows; the call has {src.numel()} "
                         f"edges {x.shape[0]} -> {n_nodes}")
    return _GatherScatter.apply(x, edge_weight, csr, reduce == "mean")


def _on_shards(x, src, dst, n_nodes, w, reduce):
    """``gather_scatter`` on DTensors (the module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    like = next(t for t in (src, x, dst, w) if isinstance(t, DTensor))
    mesh = like.device_mesh

    def dt(t):
        return t if t is None or isinstance(t, DTensor) else \
            DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x, src, dst, w = dt(x), dt(src), dt(dst), dt(w)
    src = sharded.keep_only(src, (0,))
    edges = list(src.placements)
    dst = sharded.to(dst, edges)
    by_edge = [i for i, p in enumerate(edges) if isinstance(p, Shard)
               and mesh.size(i) > 1]
    x = sharded.keep_only(x, range(1, x.dim()))
    x = sharded.to(x, [Replicate() if isinstance(edges[i], Shard) else p
                       for i, p in enumerate(x.placements)])
    x_pl = list(x.placements)
    out_pl = [Partial() if isinstance(edges[i], Shard) else p
              for i, p in enumerate(x_pl)]
    grad_pl = out_pl
    local_reduce = "sum" if by_edge else reduce
    args, in_pl = [x, src, dst], [x_pl, edges, edges]
    if w is not None:
        args.append(sharded.to(w, edges))
        in_pl.append(edges)

    def local(xl, sl, dl, wl=None):
        return gather_scatter(xl, sl, dl, n_nodes, wl, local_reduce)
    out = local_map(local, out_placements=(out_pl,), in_placements=in_pl,
                    in_grad_placements=[grad_pl] + in_pl[1:],
                    device_mesh=mesh)(*args)
    if reduce == "sum" or not by_edge:
        return out
    # the mean over every edge into a row: the counts are partial sums
    # over the edge-sharding mesh dims too
    count = local_map(
        lambda dl: torch.zeros(n_nodes, device=dl.device).index_add_(
            0, dl.long(), torch.ones(dl.shape[0], device=dl.device)),
        out_placements=([Partial() if isinstance(p, Shard) else Replicate()
                         for p in edges],),
        in_placements=(edges,), device_mesh=mesh)(dst)
    scale = 1.0 / torch.clamp(count, min=1.0)
    return out * scale.reshape((-1,) + (1,) * (out.dim() - 1))


def _record(x: torch.Tensor, n_out: int, n_edges: int,
            out_dtype: torch.dtype, weighted: bool, mean: bool,
            ptr_rows: int) -> None:
    """Record one launch's ``work`` while an operation count runs."""
    if counting_work():
        d = math.prod(x.shape[1:])
        record_work("gather_scatter", work(
            x.shape[0], n_out, d, n_edges, x.element_size(),
            torch.empty((), dtype=out_dtype).element_size(),
            weighted=weighted, ptr_rows=ptr_rows, mean=mean))


class _MetaGatherScatter(torch.autograd.Function):
    """``gather_scatter`` on meta tensors: shapes and the kernel's work,
    forward and gradient, with no CSR."""

    @staticmethod
    def forward(ctx, x, w, n_nodes, n_edges, mean, uniform):
        out_dtype = x.dtype if w is None else torch.result_type(x, w)
        ptr_rows = 0 if uniform else n_nodes
        _record(x, n_nodes, n_edges, out_dtype, w is not None, mean,
                ptr_rows)
        ctx.args = (x.shape, x.dtype, n_edges, w is not None, ptr_rows)
        return x.new_empty((n_nodes,) + tuple(x.shape[1:]), dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        x_shape, x_dtype, n_edges, weighted, ptr_rows = ctx.args
        _record(g, x_shape[0], n_edges, x_dtype, weighted, False, ptr_rows)
        return (g.new_empty(x_shape, dtype=x_dtype), None, None, None, None,
                None)


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, csr, mean):
        out_dtype = x.dtype if w is None else torch.result_type(x, w)
        _record(x, csr.n_nodes, csr.rows.col.numel(), out_dtype,
                w is not None, mean, 0 if csr.uniform else csr.n_nodes)
        ws = None if w is None else w.to(torch.float32)[csr.rows.perm]
        out = launch(x.reshape(x.shape[0], -1), csr.rows, ws, mean,
                     out_dtype)
        ctx.csr, ctx.mean, ctx.x_shape, ctx.x_dtype = csr, mean, x.shape, \
            x.dtype
        ctx.save_for_backward(w)
        return out.reshape((csr.n_nodes,) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (w,) = ctx.saved_tensors
        csr = ctx.csr
        _record(g, csr.n_src, csr.rows.col.numel(), ctx.x_dtype,
                w is not None, False, 0 if csr.uniform else csr.n_nodes)
        rows_t = csr.transposed()
        ws = None if w is None else w.to(torch.float32)[rows_t.perm]
        dx = launch(g.reshape(g.shape[0], -1), rows_t, ws, False,
                    ctx.x_dtype, scale=csr.count if ctx.mean else None)
        return dx.reshape(ctx.x_shape), None, None, None


def _check(x: torch.Tensor, rows: RowCSR, w: Optional[torch.Tensor],
           out_dtype: torch.dtype, scale: Optional[torch.Tensor]) -> None:
    dev = x.device
    named = (("ptr", rows.ptr, torch.int64), ("col", rows.col, torch.int32),
             ("long_rows", rows.long_rows, torch.int32),
             ("n_long", rows.n_long, torch.int32), ("w", w, torch.float32),
             ("scale", scale, torch.float32))
    if not x.is_cuda or any(t is not None and t.device != dev
                            for _, t, _ in named):
        raise ValueError("gather_scatter: x, the CSR and the weights must be "
                         "on one CUDA device")
    for name, t, dt in named:
        if t is None:
            continue
        if t.dtype != dt:
            raise ValueError(f"gather_scatter: {name} must be {dt}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gather_scatter: {name} must be contiguous")
    for name, dt in (("x", x.dtype), ("out", out_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gather_scatter: {name} must be float32 or "
                             f"bfloat16, got {dt}")
    if w is not None and w.numel() != rows.col.numel():
        raise ValueError(f"gather_scatter: {w.numel()} weights for "
                         f"{rows.col.numel()} edges")
    if scale is not None and scale.numel() != x.shape[0]:
        raise ValueError(f"gather_scatter: scale has {scale.numel()} "
                         f"entries for {x.shape[0]} rows of x")
    if x.shape[1] >= 2 ** 31 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"gather_scatter: x {tuple(x.shape)} past int32")


def launch(x: torch.Tensor, rows: RowCSR, w: Optional[torch.Tensor],
           mean: bool, out_dtype: torch.dtype,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel ``gather_scatter`` over a CSR: x [n_x, d], ``rows``, w [E]
    float32 or None in CSR order -> out [n, d] in ``out_dtype``.
    ``scale`` [n_x] float32: each edge's weight divided by max(scale[col],
    1) (the gradient of the mean).  Counts the launch."""
    x = x.contiguous()
    _check(x, rows, w, out_dtype, scale)
    n, d = rows.ptr.numel() - 1, x.shape[1]
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    if n == 0 or d == 0:
        return out
    lib = load("gather_scatter", _SIGNATURES)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.gather_scatter(
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            int(out_dtype == torch.bfloat16), rows.ptr.data_ptr(),
            rows.col.data_ptr(), ptr(w), ptr(scale),
            rows.long_rows.data_ptr(), rows.n_long.data_ptr(),
            rows.long_min, rows.work.data_ptr(), n, rows.col.numel(), d,
            int(mean), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("gather_scatter", err)
    launches.add()
    return out
