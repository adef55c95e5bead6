"""The GNN family: GCN, GraphSAGE, GIN and GAT (SpMM and edge-softmax),
SchNet and Equiformer-v2 (geometric), each an ``nn.Module`` whose
parameters are named as the reference's parameter tree."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.gnn.common import (GNNModule,  # noqa: F401
                                           segment_mean, segment_softmax)
from repro_torch.training.tree import flatten_with_paths

#: parameter groups the reference stacks along a leading layer axis
_STACKED = {"schnet": "interactions", "equiformer_v2": "layers"}


def build_gnn(cfg, d_in: int, n_out: int, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> GNNModule:
    """The GNN of ``cfg.kind`` for ``d_in`` input features and ``n_out``
    outputs, on ``device`` (default: the CUDA card)."""
    kw = dict(device=device, generator=generator)
    if cfg.kind == "gcn":
        from repro_torch.models.gnn.gcn import GCN
        return GCN(cfg, d_in, n_out, **kw)
    if cfg.kind == "graphsage":
        from repro_torch.models.gnn.graphsage import GraphSAGE
        return GraphSAGE(cfg, d_in, n_out, **kw)
    if cfg.kind == "schnet":
        from repro_torch.models.gnn.schnet import SchNet
        return SchNet(cfg, d_in, n_out, **kw)
    if cfg.kind == "equiformer_v2":
        from repro_torch.models.gnn.equiformer import EquiformerV2
        return EquiformerV2(cfg, d_in, n_out, **kw)
    if cfg.kind == "gat":
        from repro_torch.models.gnn.gat import GAT
        return GAT(cfg, d_in, n_out, **kw)
    if cfg.kind == "gin":
        from repro_torch.models.gnn.gin import GIN
        return GIN(cfg, d_in, n_out, **kw)
    raise KeyError(cfg.kind)


@torch.no_grad()
def gnn_params_from_jax(model: GNNModule, tree: Dict[str, Any]) -> GNNModule:
    """Load the reference GNN's parameter pytree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model``, which is returned.  SchNet's
    ``interactions`` and Equiformer's ``layers`` are stacked along a
    leading layer axis there and unstacked here; every other leaf maps by
    its path (``layers/0/w1`` is ``layers.0.w1``).  A leaf set or a shape
    that does not match the model raises."""
    stacked = _STACKED.get(model.cfg.kind)
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in flatten_with_paths(tree).items():
        arr = np.array(leaf, dtype=np.float32)
        top, _, rest = path.partition("/")
        if top == stacked:
            for i in range(arr.shape[0]):
                flat[f"{top}.{i}.{rest.replace('/', '.')}"] = arr[i]
        else:
            flat[path.replace("/", ".")] = arr
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(f"gnn_params_from_jax: the tree's leaves "
                         f"{sorted(set(flat) ^ set(params))} do not match "
                         f"the model's")
    for name, p in params.items():
        if tuple(flat[name].shape) != tuple(p.shape):
            raise ValueError(f"gnn_params_from_jax: {name} has shape "
                             f"{flat[name].shape}, the model "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(flat[name]).to(p.dtype))
    return model
