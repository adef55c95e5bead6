"""GNN training step: every GNN shape reduces to one edge-list training step,
the reference's ``launch/gnn_steps.py`` without meshes, shardings or
abstract shapes -- one card runs it eagerly.

  * full_graph / full-batch-large : (feats, [pos], src, dst, mask, labels)
  * minibatch                     : the sampled block-graph (same layout;
                                    loss only on the first ``seeds`` nodes)
  * molecule (batched)            : graphs flattened with offsets +
                                    graph_ids, MSE on a mean-readout target

Padding: node/edge counts are padded up as the reference pads them
(``GNNCell``); padded edges carry mask False, padded nodes label -1.
Features past 500,000 nodes are stored in bf16 and cast to the config's
float32 before compute, as the reference stores them.  ``gnn_rules`` and
``cell_of`` read only a mesh's axis names and sizes (a ``DeviceMesh`` or a
stand-in with ``axis_names`` and a ``shape`` mapping), as the port's
``distributed/sharding.py`` does; no step here is sharded.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchSpec, GraphShape
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (ShardingRules, base_rules,
                                              mesh_axes)
from repro_torch.models.gnn.common import segment_sum
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            gradients)

#: the reference's GNN optimizer (``gnn_steps.py:133``)
OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

#: nodes past which features are stored in bf16
BF16_FEATS_PAST = 500_000

#: one device, the reference's smoke-mesh axes
ONE_DEVICE = SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 1, "model": 1})


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def gnn_rules(mesh: Any, *, shard_nodes: bool, channel_shard: bool
              ) -> ShardingRules:
    r = base_rules(mesh)
    axes = mesh_axes(mesh)
    has = lambda a: axes.get(a, 1) > 1  # noqa: E731
    over: Dict[str, Any] = {
        "edge": "data" if has("data") else None,
        "node": (tuple(a for a in ("data", "model") if has(a)) or None)
        if shard_nodes else None,
        "channel": ("model" if (channel_shard and has("model")) else None),
        "channel_out": None,
        "graph": (tuple(a for a in ("pod", "data") if has(a)) or None),
    }
    return r.with_overrides(**over)


@dataclasses.dataclass
class GNNCell:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_out: int
    needs_pos: bool
    shard_nodes: bool
    channel_shard: bool
    chunk: Optional[int]
    graph_level: bool = False
    n_graphs: int = 0
    seeds: int = 0                      # minibatch: loss on first `seeds` nodes


def cell_of(spec: ArchSpec, shape: GraphShape, mesh: Any = ONE_DEVICE
            ) -> GNNCell:
    cfg = spec.model
    kind = cfg.kind
    needs_pos = kind in ("schnet", "equiformer_v2")
    big = shape.n_nodes > BF16_FEATS_PAST
    axes = mesh_axes(mesh)
    d_shard = max(axes.get("data", 1), 1)
    total = math.prod(axes.values())

    if shape.kind == "batched":      # molecule
        g = shape.batch_graphs
        n_nodes = g * shape.n_nodes
        n_edges = _pad_to(g * shape.n_edges, 512)
        return GNNCell(n_nodes=n_nodes, n_edges=n_edges, d_feat=100,
                       n_out=1, needs_pos=needs_pos, shard_nodes=False,
                       channel_shard=(kind == "equiformer_v2"), chunk=None,
                       graph_level=True, n_graphs=g)
    if shape.kind == "minibatch":
        b = shape.batch_nodes
        f1, f2 = shape.fanout
        n_nodes = b * (1 + f1 + f1 * f2)
        n_edges = b * f1 + b * f1 * f2
        chunk = None
        if kind == "equiformer_v2":
            chunk = _pick_chunk(n_edges, d_shard)
        return GNNCell(n_nodes=_pad_to(n_nodes, 512),
                       n_edges=_pad_to(n_edges, 512 if chunk is None else chunk),
                       d_feat=shape.d_feat, n_out=spec.model.n_classes,
                       needs_pos=needs_pos, shard_nodes=False,
                       channel_shard=(kind == "equiformer_v2"),
                       chunk=chunk, seeds=b)
    # full graph
    chunk = None
    if kind == "equiformer_v2" and shape.n_edges > 1_000_000:
        chunk = _pick_chunk(shape.n_edges, d_shard)
    n_edges = _pad_to(shape.n_edges, 512 if chunk is None else chunk)
    shard_nodes = big and kind != "equiformer_v2"
    return GNNCell(
        n_nodes=_pad_to(shape.n_nodes, total * 2) if shard_nodes else shape.n_nodes,
        n_edges=n_edges, d_feat=shape.d_feat, n_out=spec.model.n_classes,
        needs_pos=needs_pos, shard_nodes=shard_nodes,
        channel_shard=(kind == "equiformer_v2"), chunk=chunk)


def _pick_chunk(n_edges: int, d_shard: int) -> int:
    """Chunk divisible by the data axis; ~32k edges per chunk."""
    base = 32_768
    while base % d_shard:
        base *= 2
    return base


def gnn_model(spec: ArchSpec, cell: GNNCell, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None):
    """``build_model`` of ``spec`` sized for ``cell`` (its feature width and
    outputs), on ``device`` (default: the CUDA card)."""
    return build_model(spec, device, generator, d_in=cell.d_feat,
                       n_out=cell.n_out)


def gnn_batch(cell: GNNCell, arrays: Dict[str, np.ndarray],
              device: DeviceLike) -> Dict[str, torch.Tensor]:
    """Arrays (``feats``, ``src``, ``dst``, optional ``edge_mask``,
    ``labels`` or ``graph_ids`` and ``target``, ``pos``; numpy or torch)
    padded to the cell's node and edge counts and moved to ``device``:
    features in bf16 past BF16_FEATS_PAST nodes (else float32), edges
    int32, the mask bool (False on padding), labels -1 on padding."""
    n, e = cell.n_nodes, cell.n_edges
    n_real, e_real = len(arrays["feats"]), len(arrays["src"])
    if n_real > n or e_real > e:
        raise ValueError(f"gnn_batch: {n_real} nodes and {e_real} edges do "
                         f"not fit the cell's {n} and {e}")

    def put(a, rows, fill, dtype):
        t = (a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a))).to(device=device, dtype=dtype)
        if rows > t.shape[0]:
            pad = torch.full((rows - t.shape[0],) + tuple(t.shape[1:]), fill,
                             dtype=dtype, device=device)
            t = torch.cat([t, pad])
        return t

    mask = arrays.get("edge_mask")
    if mask is None:
        mask = torch.ones(e_real, dtype=torch.bool)
    feats = torch.bfloat16 if n > BF16_FEATS_PAST else torch.float32
    batch = {"feats": put(arrays["feats"], n, 0, feats),
             "src": put(arrays["src"], e, 0, torch.int32),
             "dst": put(arrays["dst"], e, 0, torch.int32),
             "edge_mask": put(mask, e, False, torch.bool)}
    if "pos" in arrays:
        batch["pos"] = put(arrays["pos"], n, 0.0, torch.float32)
    if cell.graph_level:
        batch["graph_ids"] = put(arrays["graph_ids"], n, 0, torch.int32)
        batch["target"] = put(arrays["target"], cell.n_graphs, 0.0,
                              torch.float32)
    else:
        batch["labels"] = put(arrays["labels"], n, -1, torch.int32)
    return batch


def gnn_loss(model, batch: Dict[str, torch.Tensor], cell: GNNCell
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``loss_fn``: node cross-entropy over labelled nodes
    (the first ``cell.seeds`` of a minibatch), or the MSE of each graph's
    mean readout against ``target`` -> (loss, lse or prediction)."""
    feats = batch["feats"]
    n = feats.shape[0]
    compute = getattr(torch, model.cfg.dtype)
    pos = batch.get("pos")
    if pos is None:
        pos = torch.zeros((n, 3), dtype=torch.float32, device=feats.device)
    logits = model(feats.to(compute), pos, batch["src"], batch["dst"],
                   batch["edge_mask"].to(torch.float32), n, chunk=cell.chunk)
    if cell.graph_level:
        gid = batch["graph_ids"]
        num = segment_sum(logits[:, 0], gid, cell.n_graphs)
        cnt = segment_sum(torch.ones(n, device=feats.device), gid,
                          cell.n_graphs)
        pred = num / torch.clamp(cnt, min=1.0)
        return torch.mean(torch.square(pred - batch["target"])), pred
    labels = batch["labels"].long()
    valid = labels >= 0
    if cell.seeds:
        valid = valid & (torch.arange(n, device=feats.device) < cell.seeds)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, torch.clamp(labels, min=0)[:, None])[:, 0]
    ce = torch.where(valid, lse - ll, 0.0)
    return torch.sum(ce) / torch.clamp(valid.sum(), min=1), lse


def gnn_train_step(model, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor],
                   cell: Optional[GNNCell] = None
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step of the GNN ``model`` on a ``gnn_batch``: the
    loss, its gradients by autograd, then AdamW (lr 1e-3, no weight decay,
    as the reference's ``gnn_bundle``), which updates the parameters in
    place.  ``cell`` (default: a full-graph node-level cell of the batch's
    size) says the loss's kind.  ``opt_state`` is
    ``init_opt_state(dict(model.named_parameters()))``.  -> (opt_state,
    {"loss", "grad_norm", "lr"})."""
    if cell is None:
        cell = GNNCell(n_nodes=batch["feats"].shape[0],
                       n_edges=batch["src"].shape[0],
                       d_feat=batch["feats"].shape[1], n_out=0,
                       needs_pos="pos" in batch, shard_nodes=False,
                       channel_shard=False, chunk=None)
    params = dict(model.named_parameters())
    loss, _ = gnn_loss(model, batch, cell)
    grads = gradients(loss, params)
    _, opt_state, om = adamw_update(grads, opt_state, params, OPT)
    return opt_state, {"loss": loss.detach(), **om}
