"""GAT [arXiv:1710.10903] (bonus arch from the pool): SDDMM edge scores ->
segment-softmax -> SpMM -- the third GNN kernel regime (edge-softmax)
alongside SpMM (GCN/SAGE) and geometric gathers (SchNet/Equiformer).

Its message weights are the attention, which carries a gradient, so its
SpMM is a torch ``index_add`` and not the ``gather_scatter`` kernel."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.models.gnn.common import (GNNModule, segment_softmax,
                                           segment_sum)


class GAT(GNNModule):
    def __init__(self, cfg: GNNConfig, d_in: int, n_out: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cfg, device)
        self.heads = h = max(cfg.n_heads, 1)
        dh = cfg.d_hidden
        dims = [d_in] + [h * dh] * (cfg.n_layers - 1) + [n_out]
        layers = []
        for i in range(cfg.n_layers):
            # hidden layers concat heads; the final layer averages them, so
            # each head emits the full n_out
            d_out = dh if i < cfg.n_layers - 1 else dims[i + 1]
            layers.append(nn.ParameterDict({
                "w": self.param(dims[i], h, d_out, init=dims[i]),
                "a_src": self.param(h, d_out, init=d_out),
                "a_dst": self.param(h, d_out, init=d_out),
            }))
        self.layers = nn.ModuleList(layers)
        self.reset_parameters(generator)

    def node_logits(self, feats, pos, src, dst, edge_mask, n_nodes,
                    chunk: Optional[int] = None):
        h = feats
        n_layers = len(self.layers)
        keep = edge_mask > 0
        for i, lp in enumerate(self.layers):
            z = torch.einsum("nd,dhk->nhk", h, lp["w"])           # [N,H,K]
            # SDDMM: per-edge attention logits
            e_src = torch.einsum("nhk,hk->nh", z, lp["a_src"])[src]
            e_dst = torch.einsum("nhk,hk->nh", z, lp["a_dst"])[dst]
            logits = F.leaky_relu(e_src + e_dst, 0.2)             # [E,H]
            logits = torch.where(keep[:, None], logits, -1e30)
            attn = segment_softmax(logits, dst, n_nodes)          # [E,H]
            msg = z[src] * attn[..., None]
            agg = segment_sum(torch.where(keep[:, None, None], msg, 0.0),
                              dst, n_nodes)                       # [N,H,K]
            if i < n_layers - 1:
                h = F.elu(agg.reshape(n_nodes, -1))               # concat heads
            else:
                h = agg.mean(dim=1)                               # average heads
        return h
