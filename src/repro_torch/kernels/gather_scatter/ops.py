"""The GNN's SpMM wrapper: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU.

``gather_scatter(x, src, dst, n_nodes, edge_weight, reduce)`` computes
``out[v] = reduce_{e: dst[e] = v} w[e] * x[src[e]]`` for ``reduce`` "sum"
or "mean" (the mean divides by every edge into v, masked ones too).  On
the card the kernel (``csrc/gather_scatter.cu``) reads the edges as a CSR
by destination, in the order of a stable sort, and sums each row in
registers: no [E, d] message tensor is built.  :class:`EdgeCSR` holds that
CSR, and the CSR by source that the gradient runs on; build it once for a
graph (``EdgeCSR.build``) and pass it to every call on that graph, forward
and backward, instead of sorting the edges a call.

The gradient is a ``torch.autograd.Function``: d x is the same kernel over
the CSR by source, with weights ``w[e] / max(count_{dst[e]}, 1)`` for the
mean.  No caller needs the weights' gradient, so weights that require one
raise.  Every call with a CUDA ``x`` launches the kernel: there is no size
gate and no fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.gather_scatter.ref import gather_scatter_ref

launches = LaunchCounter("gather_scatter")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"gather_scatter": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I,
                                  _P]}


def _csr(key: torch.Tensor, other: torch.Tensor, n: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ptr [n + 1] int64, perm [E] int64, col [E] int32): the edges in the
    order of a stable sort by ``key``, ``col = other[perm]``."""
    perm = torch.sort(key, stable=True).indices
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(torch.bincount(key, minlength=n), 0, out=ptr[1:])
    return ptr, perm, other[perm].to(torch.int32)


@dataclasses.dataclass
class EdgeCSR:
    """The edges ``src -> dst`` of one graph as the kernel reads them: by
    destination (``ptr``, ``perm``, ``col``; ``count`` [n_nodes] float32,
    the edges into each node), and, built at the first backward, by source
    (``ptr_t``, ``perm_t``, ``col_t``) over ``n_src`` rows."""

    n_nodes: int
    n_src: int
    src: torch.Tensor
    dst: torch.Tensor
    ptr: torch.Tensor
    perm: torch.Tensor
    col: torch.Tensor
    count: torch.Tensor
    ptr_t: Optional[torch.Tensor] = None
    perm_t: Optional[torch.Tensor] = None
    col_t: Optional[torch.Tensor] = None

    @staticmethod
    def build(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              n_src: Optional[int] = None) -> "EdgeCSR":
        """The CSR by destination of edges ``src[e] -> dst[e]`` (``n_src``,
        the rows of ``x``, defaults to ``n_nodes``): one stable
        ``torch.sort``, a ``bincount`` and a ``cumsum`` on the edges'
        device."""
        if src.shape != dst.shape or src.dim() != 1:
            raise ValueError(f"EdgeCSR: src {tuple(src.shape)} and dst "
                             f"{tuple(dst.shape)} must be one 1-D shape")
        ptr, perm, col = _csr(dst, src, n_nodes)
        return EdgeCSR(n_nodes, n_nodes if n_src is None else n_src, src,
                       dst, ptr, perm, col,
                       (ptr[1:] - ptr[:-1]).to(torch.float32))

    def transposed(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(ptr_t, perm_t, col_t): the CSR by source, built once."""
        if self.ptr_t is None:
            self.ptr_t, self.perm_t, self.col_t = _csr(self.src, self.dst,
                                                       self.n_src)
        return self.ptr_t, self.perm_t, self.col_t


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
    if x.device.type == "cpu":
        return gather_scatter_ref(x, src, dst, n_nodes, edge_weight, reduce)
    if edge_weight is not None and edge_weight.requires_grad:
        raise ValueError("gather_scatter: the kernel gives no gradient for "
                         "the edge weights")
    if csr is None:
        csr = EdgeCSR.build(src, dst, n_nodes, x.shape[0])
    if csr.n_nodes != n_nodes or csr.n_src != x.shape[0] \
            or csr.col.numel() != src.numel():
        raise ValueError(f"gather_scatter: the CSR is of {csr.col.numel()} "
                         f"edges {csr.n_src} -> {csr.n_nodes} rows; the call "
                         f"has {src.numel()} edges {x.shape[0]} -> {n_nodes}")
    return _GatherScatter.apply(x, edge_weight, csr, reduce == "mean")


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, csr, mean):
        out_dtype = x.dtype if w is None else torch.result_type(x, w)
        ws = None if w is None else w.to(torch.float32)[csr.perm]
        out = launch(x.reshape(x.shape[0], -1), csr.ptr, csr.col, ws, mean,
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
        ptr_t, perm_t, col_t = csr.transposed()
        ws = None if w is None else w.to(torch.float32)[perm_t]
        if ctx.mean:
            inv = torch.clamp(csr.count, min=1.0)[col_t.long()]
            ws = 1.0 / inv if ws is None else ws / inv
        dx = launch(g.reshape(g.shape[0], -1), ptr_t, col_t, ws, False,
                    ctx.x_dtype)
        return dx.reshape(ctx.x_shape), None, None, None


def _check(x: torch.Tensor, ptr: torch.Tensor, col: torch.Tensor,
           w: Optional[torch.Tensor], out_dtype: torch.dtype) -> None:
    dev = x.device
    if not x.is_cuda or any(t is not None and t.device != dev
                            for t in (ptr, col, w)):
        raise ValueError("gather_scatter: x, the CSR and the weights must be "
                         "on one CUDA device")
    for name, t, dt in (("x", x, None), ("ptr", ptr, torch.int64),
                        ("col", col, torch.int32), ("w", w, torch.float32)):
        if t is None:
            continue
        if dt is not None and t.dtype != dt:
            raise ValueError(f"gather_scatter: {name} must be {dt}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"gather_scatter: {name} must be contiguous")
    for name, dt in (("x", x.dtype), ("out", out_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"gather_scatter: {name} must be float32 or "
                             f"bfloat16, got {dt}")
    if w is not None and w.numel() != col.numel():
        raise ValueError(f"gather_scatter: {w.numel()} weights for "
                         f"{col.numel()} edges")
    if x.shape[1] >= 2 ** 31 or x.shape[0] >= 2 ** 31:
        raise ValueError(f"gather_scatter: x {tuple(x.shape)} past int32")


def launch(x: torch.Tensor, ptr: torch.Tensor, col: torch.Tensor,
           w: Optional[torch.Tensor], mean: bool,
           out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel ``gather_scatter`` over a CSR: x [n_x, d], ptr [n + 1] int64,
    col [E] int32, w [E] float32 or None, all in CSR order -> out [n, d] in
    ``out_dtype``.  Counts the launch."""
    x = x.contiguous()
    _check(x, ptr, col, w, out_dtype)
    n, d = ptr.numel() - 1, x.shape[1]
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    if n == 0 or d == 0:
        return out
    lib = load("gather_scatter", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.gather_scatter(
            x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            int(out_dtype == torch.bfloat16), ptr.data_ptr(), col.data_ptr(),
            None if w is None else w.data_ptr(), n, d, int(mean),
            torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("gather_scatter", err)
    launches.add()
    return out
