"""Plain PyTorch version of the GNN's SpMM, the reference's
``gather_scatter`` (``models/gnn/common.py``): the messages ``x[src] * w``
as an [E, ...] tensor, then ``index_add_`` by ``dst``; ``mean`` divides by
the count of every edge into a node, masked (weight-0) edges too, at least
1.  The CPU path and the tests use it; a tensor on the card goes to the
CUDA kernel instead.

On the CPU ``index_add_`` adds the messages in edge order, each to a zeroed
row, so a float32 row is ``((0 + m0) + m1) + ...``: the kernel sums in the
same order and agrees bit for bit.  The messages take the type of ``x *
w`` (float32 for bf16 ``x`` and float32 weights); bf16 messages with no
weight are summed in bf16, rounded at every add, as the reference's
``segment_sum`` sums them."""
from __future__ import annotations

from typing import Optional

import torch


def gather_scatter_ref(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       n_nodes: int, edge_weight: Optional[torch.Tensor] = None,
                       reduce: str = "sum") -> torch.Tensor:
    """out[v] = reduce_{e: dst[e] = v} w[e] * x[src[e]]: [n_nodes, ...]."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"gather_scatter: reduce {reduce!r} is not sum or "
                         f"mean")
    msg = x[src]
    if edge_weight is not None:
        msg = msg * edge_weight.reshape((-1,) + (1,) * (x.dim() - 1))
    out = torch.zeros((n_nodes,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device).index_add_(0, dst, msg)
    if reduce == "mean":
        ones = torch.ones(msg.shape[0], dtype=msg.dtype, device=msg.device)
        count = torch.zeros(n_nodes, dtype=msg.dtype,
                            device=msg.device).index_add_(0, dst, ones)
        out = out / torch.clamp(count, min=1.0).reshape(
            (-1,) + (1,) * (msg.dim() - 1))
    return out
