"""GIN [arXiv:1810.00826] (bonus arch from the pool): sum-aggregation SpMM
with a learnable epsilon + MLP update -- maximally discriminative WL-style
message passing."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.models.gnn.common import GNNModule, edge_csr, gather_scatter


class GIN(GNNModule):
    def __init__(self, cfg: GNNConfig, d_in: int, n_out: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cfg, device)
        dims = [d_in] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList([nn.ParameterDict({
            "w1": self.param(dims[i], dims[i + 1], init=dims[i]),
            "w2": self.param(dims[i + 1], dims[i + 1], init=dims[i + 1]),
            "eps": self.param(init=0.0),
        }) for i in range(cfg.n_layers)])
        self.head = self.param(cfg.d_hidden, n_out, init=cfg.d_hidden)
        self.reset_parameters(generator)

    def node_logits(self, feats, pos, src, dst, edge_mask, n_nodes,
                    chunk: Optional[int] = None):
        h = feats
        ew = edge_mask.to(torch.float32)
        csr = edge_csr(feats, src, dst, n_nodes)
        for lp in self.layers:
            agg = gather_scatter(h, src, dst, n_nodes, edge_weight=ew,
                                 csr=csr)
            z = (1.0 + lp["eps"]) * h + agg
            h = torch.relu(torch.relu(z @ lp["w1"]) @ lp["w2"])
        return h @ self.head
