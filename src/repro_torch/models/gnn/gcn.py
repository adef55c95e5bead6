"""GCN [arXiv:1609.02907]: sym-normalized SpMM Ã X W, 2 layers d=16."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.models.gnn.common import (GNNModule, edge_csr,
                                           gather_scatter, segment_sum,
                                           sym_norm_coeff)


class GCN(GNNModule):
    def __init__(self, cfg: GNNConfig, d_in: int, n_out: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cfg, device)
        dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [n_out]
        self.w = nn.ParameterList([self.param(dims[i], dims[i + 1],
                                              init=dims[i])
                                   for i in range(cfg.n_layers)])
        self.reset_parameters(generator)

    def node_logits(self, feats, pos, src, dst, edge_mask, n_nodes,
                    chunk: Optional[int] = None):
        mask = edge_mask.to(torch.float32)
        coeff = sym_norm_coeff(src, dst, n_nodes, mask) * edge_mask
        deg_self = 1.0 / (segment_sum(edge_mask * 1.0, dst, n_nodes) + 1.0)
        csr = edge_csr(feats, src, dst, n_nodes)
        h = feats
        for i, w in enumerate(self.w):
            hw = h @ w
            agg = gather_scatter(hw, src, dst, n_nodes, edge_weight=coeff,
                                 csr=csr)
            h = agg + hw * deg_self[:, None]               # self-loop term
            if i < len(self.w) - 1:
                h = torch.relu(h)
        return h
