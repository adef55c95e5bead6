"""EmbeddingBag, the reference's ``models/recsys/embedding_bag.py``: the
lookup layer of the recsys family.  Two layouts:

  * dense multi-hot  [B, F, H] ids         -> [B, F, D]  (AutoInt path)
  * ragged           (ids [T], offsets [B]) -> [B, D]    (torch-parity path)

A bag's sum or mean is the GNN's SpMM in another form: the rows are the
tables, each id an edge from its table row to its bag.  Both go to the
``gather_scatter`` kernel (``kernels/gather_scatter``), forward and
gradient, which on the card sums each bag in registers from a CSR of the
ids and builds no [T, D] tensor of rows; on the CPU they take its plain
version, which adds in the kernel's order.  A dense bag's ids already lie
in bag order, H to a bag, so its CSR is built with no sort
(``EdgeCSR.regular``).  The max is a gather and a torch reduction, as
GraphSAGE's max is kept.  No path differentiates the weights: on the card
weights that require a gradient raise.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.gather_scatter.ops import EdgeCSR, gather_scatter

MODES = ("sum", "mean", "max")


def _mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} is not one of "
                         f"{MODES}")
    return mode


def embedding_bag_dense(table: torch.Tensor, ids: torch.Tensor,
                        mode: str = "mean",
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """table [F, V, D]; ids [B, F, H] (each field's ids index its own
    table) -> [B, F, D], reduced over H; ``weights`` [B, F, H] scale each
    row first.  The mean divides by H.

    On DTensors each rank runs the kernel on its shard of the table: a
    table sharded by fields (the reference's ``field`` rule) is looked up
    by the ids of those fields, cut locally, the bags sharded alike; a
    table sharded by rows (``table_row``) is looked up by every bag's ids
    (gathered whole) that fall in its rows, weight 0 for the others, and
    the pooled bags, partial sums over the row-sharding mesh dims, are
    reduced (a row-wise sharded embedding's reduce-scatter).  The bags
    come back placed as the ids were."""
    _mode(mode)
    if isinstance(table, DTensor) or isinstance(ids, DTensor):
        return _dense_on_shards(table, ids, mode, weights)
    f, v, d = table.shape
    b, _, h = ids.shape
    rows = table.reshape(f * v, d)
    base = torch.arange(f, dtype=torch.int64, device=ids.device) * v
    src = (ids.long() + base[None, :, None]).reshape(-1)
    if mode == "max":
        g = rows[src].reshape(b, f, h, d)
        if weights is not None:
            g = g * weights[..., None]
        return torch.amax(g, dim=2)
    csr = EdgeCSR.regular(src.to(torch.int32), h, f * v)
    w = None if weights is None else weights.reshape(-1)
    return gather_scatter(rows, csr.src, csr.dst, b * f, w, mode,
                          csr).reshape(b, f, d)


def _dense_on_shards(table, ids, mode, weights):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels import sharded

    if mode == "max" or weights is not None:
        raise ValueError("embedding_bag_dense on shards: sum or mean of "
                         "unweighted bags only")
    mesh = table.device_mesh
    table = sharded.keep_only(table, (0, 1))
    by_field = [i for i, p in enumerate(table.placements)
                if isinstance(p, Shard) and p.dim == 0]
    by_row = [i for i, p in enumerate(table.placements)
              if isinstance(p, Shard) and p.dim == 1]
    ids = sharded.keep_only(ids, (0,))
    ids_pl = list(ids.placements)
    # each rank's fields' ids (a local cut), and every bag where it holds
    # a share of the rows (gathered)
    ids = sharded.to(ids, [Shard(1) if i in by_field else Replicate()
                           if i in by_row else p
                           for i, p in enumerate(ids_pl)])
    first = sharded.offset(table, 1)
    out_pl = [Partial() if i in by_row else p
              for i, p in enumerate(ids.placements)]

    def local(tl, il):
        if not by_row:
            return embedding_bag_dense(tl, il, mode)
        col = il.long() - first
        mine = (col >= 0) & (col < tl.shape[1])
        return embedding_bag_dense(
            tl, torch.where(mine, col, 0).to(il.dtype), mode,
            weights=mine.to(tl.dtype))
    out = local_map(local, out_placements=(out_pl,),
                    in_placements=(list(table.placements),
                                   list(ids.placements)),
                    in_grad_placements=(list(table.placements),
                                        list(ids.placements)),
                    device_mesh=mesh)(table, ids)
    # the bags whole over fields and reduced over rows, placed as the ids
    # were: the next layer (AutoInt's attention) weighs every field
    return sharded.to(out, ids_pl)


def embedding_bag_ragged(table: torch.Tensor, ids: torch.Tensor,
                         offsets: torch.Tensor, n_bags: int,
                         mode: str = "mean") -> torch.Tensor:
    """table [V, D]; ids [T] flat, offsets [B] bag starts -> [B, D]: the
    torch ``nn.EmbeddingBag(ids, offsets)`` contract.  Each id's bag is
    ``searchsorted(offsets, t, right) - 1``; ids before ``offsets[0]``
    belong to no bag and are dropped, as the reference's segment ops drop
    a negative segment.  An empty bag gives 0 under sum and mean, -inf
    under max; the mean divides by max(count, 1)."""
    _mode(mode)
    t = ids.shape[0]
    pos = torch.arange(t, dtype=torch.int64, device=ids.device)
    # bag + 1: row 0 takes the ids of no bag and is cut off
    dst = torch.searchsorted(offsets.to(torch.int64), pos, right=True)
    if mode == "max":
        rows = table[ids.long()]
        idx = dst[:, None].expand_as(rows)
        out = torch.full((n_bags + 1, table.shape[1]), -torch.inf,
                         dtype=rows.dtype, device=rows.device)
        return out.scatter_reduce(0, idx, rows, "amax",
                                  include_self=False)[1:]
    return gather_scatter(table, ids.to(torch.int32), dst.to(torch.int32),
                          n_bags + 1, None, mode)[1:]
