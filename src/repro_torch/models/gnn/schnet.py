"""SchNet [arXiv:1706.08566]: continuous-filter convolutions, 3 interactions.

Kernel regime 2 (triplet-free geometric gather): RBF(r_uv) -> filter MLP ->
elementwise product with gathered neighbor features -> segment_sum.  The
reference's scan over stacked interactions is a loop over
``interactions``, one parameter dict a block; its messages carry learned
filters, so the sum is a torch ``index_add``."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike
from repro_torch.models.gnn.common import (GNNModule, gather_rows,
                                           segment_sum)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x) - math.log(2.0)


class SchNet(GNNModule):
    def __init__(self, cfg: GNNConfig, d_in: int, n_out: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(cfg, device)
        c, r = cfg.d_hidden, cfg.n_rbf
        self.embed = self.param(d_in, c, init=d_in)
        self.interactions = nn.ModuleList([nn.ParameterDict({
            "filter_w1": self.param(r, c, init=r),
            "filter_w2": self.param(c, c, init=c),
            "w_in": self.param(c, c, init=c),
            "w_out": self.param(c, c, init=c),
        }) for _ in range(cfg.n_layers)])
        self.head = self.param(c, n_out, init=c)
        self.reset_parameters(generator)

    def _rbf(self, r: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, device=r.device)
        gamma = 10.0 / cfg.cutoff
        return torch.exp(-gamma * torch.square(r[..., None] - mu))

    def node_logits(self, feats, pos, src, dst, edge_mask, n_nodes,
                    chunk: Optional[int] = None):
        h = self.pin(self.pin(feats) @ self.embed)
        rel = gather_rows(pos, dst) - gather_rows(pos, src)
        r = torch.linalg.vector_norm(rel, dim=-1)
        rbf = self.pin_edges(self._rbf(r))
        cutoff_w = 0.5 * (torch.cos(math.pi * torch.clamp(
            r / self.cfg.cutoff, 0, 1)) + 1)
        ew = (edge_mask * cutoff_w)[:, None]
        for ip in self.interactions:
            w = self.pin_edges(shifted_softplus(rbf @ ip["filter_w1"])
                               @ ip["filter_w2"])
            msg = self.pin_edges(gather_rows(self.pin(h @ ip["w_in"]), src)
                                 * w * ew)
            agg = self.pin(segment_sum(msg, dst, n_nodes))
            h = self.pin(h + shifted_softplus(agg @ ip["w_out"]))
        return self.pin(shifted_softplus(h) @ self.head)
