"""GraphSAGE [arXiv:1706.02216], mean aggregator, 2 layers d=128.

Works on any edge-list graph; the ``minibatch_lg`` shape feeds it the
neighbor-sampled block graph produced by ``repro_torch.data.sampler``.  The
mean runs the ``gather_scatter`` kernel on the card (one CSR a forward, for
both layers and the backward); ``aggregator="max"``, which no config
reaches, stays on torch scatter ops."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.models.gnn.common import GNNModule, edge_csr, gather_scatter


class GraphSAGE(GNNModule):
    def __init__(self, cfg: GNNConfig, d_in: int, n_out: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cfg, device)
        dims = [d_in] + [cfg.d_hidden] * cfg.n_layers
        self.w_self = nn.ParameterList(
            [self.param(dims[i], dims[i + 1], init=dims[i])
             for i in range(cfg.n_layers)])
        self.w_nbr = nn.ParameterList(
            [self.param(dims[i], dims[i + 1], init=dims[i])
             for i in range(cfg.n_layers)])
        self.head = self.param(cfg.d_hidden, n_out, init=cfg.d_hidden)
        self.reset_parameters(generator)

    def node_logits(self, feats, pos, src, dst, edge_mask, n_nodes,
                    chunk: Optional[int] = None):
        h = feats
        ew = edge_mask.to(torch.float32)
        mean = self.cfg.aggregator == "mean"
        csr = edge_csr(feats, src, dst, n_nodes) if mean else None
        for ws, wn in zip(self.w_self, self.w_nbr):
            agg = gather_scatter(h, src, dst, n_nodes, edge_weight=ew,
                                 reduce="mean" if mean else "max", csr=csr)
            h = torch.relu(h @ ws + agg @ wn)
            h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1,
                                                         keepdim=True),
                                min=1e-9)
        return h @ self.head
