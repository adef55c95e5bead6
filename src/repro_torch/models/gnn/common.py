"""GNN message-passing primitives, the reference's ``models/gnn/common.py``
over an edge list ``(src, dst)``.

``gather_scatter`` is the system's SpMM layer: its sum and mean go to the
``gather_scatter`` kernel (``kernels/gather_scatter``), which on the card
sums each destination row in registers from a CSR of the edges and builds
no [E, d] message tensor; on the CPU they take its plain version.  Its max,
and the other segment reductions here, are torch scatter ops
(``index_add_``, ``scatter_reduce``); on CUDA those add with atomics, so
their sums are not bitwise repeatable there.

Reference semantics kept: ``segment_mean`` divides by the count of every
edge into a node, masked ones too (GraphSAGE passes the mask as a weight,
so padded edges dilute the mean); ``segment_max`` gives -inf to an empty
segment, and ``segment_softmax`` maps a non-finite maximum to 0.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gather_scatter import ops as gs_ops
from repro_torch.kernels.gather_scatter.ops import EdgeCSR
from repro_torch.models.layers import dense_init_


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """[E] -> [E, 1, ...] against an ``ndim``-D tensor."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return torch.zeros((num_segments,) + tuple(data.shape[1:]),
                       dtype=data.dtype, device=data.device
                       ).index_add(0, segment_ids, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max over each segment; -inf where a segment is empty."""
    idx = _bcast(segment_ids.long(), data.dim()).expand_as(data)
    return torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                      dtype=data.dtype, device=data.device
                      ).scatter_reduce(0, idx, data, "amax",
                                       include_self=False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    c = segment_sum(torch.ones(data.shape[:1], dtype=data.dtype,
                               device=data.device), segment_ids, num_segments)
    return s / _bcast(torch.clamp(c, min=1.0), data.dim())


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax over edges grouped by destination node (edge-softmax).  The
    shift by each segment's maximum carries no gradient: softmax does not
    depend on it (the reference differentiates through it, which adds
    only rounding)."""
    smax = segment_max(scores.detach(), segment_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - smax[segment_ids])
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(den[segment_ids], min=1e-16)


def edge_csr(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             n_nodes: int) -> Optional[EdgeCSR]:
    """The kernel's CSR of a graph whose node table is ``x``, built once
    for every ``gather_scatter`` of a forward and its backward; None on the
    CPU, where the plain version needs none."""
    if x.device.type == "cpu":
        return None
    return EdgeCSR.build(src, dst, n_nodes, x.shape[0])


def gather_scatter(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n_nodes: int, edge_weight: Optional[torch.Tensor] = None,
                   reduce: str = "sum", csr: Optional[EdgeCSR] = None
                   ) -> torch.Tensor:
    """One SpMM: out[v] = reduce_{(u,v) in E} w_uv * x[u].  "sum" and
    "mean" run the kernel (over ``csr`` where given); "max" is a torch
    scatter."""
    if reduce == "max":
        msg = x[src]
        if edge_weight is not None:
            msg = msg * _bcast(edge_weight, x.dim())
        return segment_max(msg, dst, n_nodes)
    return gs_ops.gather_scatter(x, src, dst, n_nodes, edge_weight, reduce,
                                 csr)


def chunked_gather_scatter(x: torch.Tensor, src: torch.Tensor,
                           dst: torch.Tensor, n_nodes: int,
                           msg_fn: Callable, chunk: int,
                           out_feat_shape: Tuple[int, ...],
                           edge_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Edge-chunked message passing for big-irrep models: ``chunk``-sized
    blocks of edges in turn, each one's ``msg_fn(x[s], s, d)`` added into
    the node buffer (bounds peak edge-activation memory to chunk x feat)."""
    e = src.shape[0]
    n_chunks = max(1, e // chunk)
    if e % n_chunks:
        raise ValueError(f"chunked_gather_scatter: {e} edges do not split "
                         f"into chunks of {chunk}")
    c = e // n_chunks
    acc = torch.zeros((n_nodes,) + tuple(out_feat_shape), dtype=x.dtype,
                      device=x.device)
    for i in range(n_chunks):
        s, d = src[i * c:(i + 1) * c], dst[i * c:(i + 1) * c]
        msg = msg_fn(x[s], s, d)
        if edge_mask is not None:
            m = _bcast(edge_mask[i * c:(i + 1) * c].bool(), msg.dim())
            msg = torch.where(m, msg, 0)
        acc = acc.index_add(0, d, msg)
    return acc


def degree(dst: torch.Tensor, n_nodes: int,
           edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ones = torch.ones(dst.shape[0], dtype=torch.float32, device=dst.device)
    if edge_mask is not None:
        ones = ones * edge_mask
    return segment_sum(ones, dst, n_nodes)


def sym_norm_coeff(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                   edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GCN symmetric normalization 1/sqrt(d_u d_v) per edge (with self-loops
    accounted by +1)."""
    deg = degree(dst, n_nodes, edge_mask) + degree(src, n_nodes, edge_mask)
    deg = deg / 2.0 + 1.0
    inv_sqrt = torch.rsqrt(torch.clamp(deg, min=1.0))
    return inv_sqrt[src] * inv_sqrt[dst]


class GNNModule(nn.Module):
    """Base of the port's GNNs: float32 parameters on ``device`` (default:
    the CUDA card; with no card and no device named it raises), laid out
    and named as the reference's parameter tree (``models/gnn/__init__.py::
    gnn_params_from_jax`` loads one), drawn from ``generator`` (default:
    seed 0 on that device) as the reference draws them: truncated-normal
    fan-in matrices, unit or zero scales.  ``forward`` is the reference's
    ``node_logits(params, feats, pos, src, dst, edge_mask, n_nodes, chunk)``
    without the params."""

    def __init__(self, cfg, device: DeviceLike = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._init: Dict[int, Union[int, float]] = {}

    def param(self, *shape: int, init: Union[int, float]) -> nn.Parameter:
        """A float32 parameter of ``shape``: ``init`` an int is the fan-in
        of a truncated-normal draw, a float a constant fill."""
        p = nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                     device=self.device))
        self._init[id(p)] = init
        return p

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        for p in self.parameters():
            init = self._init[id(p)]
            if isinstance(init, float):
                p.fill_(init)
            else:
                dense_init_(p, init, generator)

    def forward(self, feats, pos, src, dst, edge_mask, n_nodes: int,
                chunk: Optional[int] = None) -> torch.Tensor:
        return self.node_logits(feats, pos, src, dst, edge_mask, n_nodes,
                                chunk)
