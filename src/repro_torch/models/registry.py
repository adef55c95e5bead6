"""build_model: ArchSpec or config -> model object."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import (ArchSpec, GNNConfig, RecsysConfig,
                                      TransformerConfig)
from repro_torch.device import DeviceLike


def build_model(spec_or_cfg: Any, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None, *,
                d_in: Optional[int] = None, n_out: Optional[int] = None):
    """The model of an ArchSpec or a config, on ``device`` (default: the
    CUDA card).  Every ``TransformerConfig`` (dense, MoE, MLA) builds an
    ``LM``; every ``GNNConfig`` its GNN, for ``d_in`` input features
    (default: the feature width of the spec's first shape, full_graph_sm's
    1,433) and ``n_out`` outputs (default: ``n_classes``;
    ``launch/gnn_steps.py::gnn_model`` sizes both from a cell); every
    ``RecsysConfig`` an ``AutoInt`` over its ``n_sparse`` fields
    (``launch/recsys_steps.py::recsys_model`` pads them for a mesh)."""
    spec = spec_or_cfg if isinstance(spec_or_cfg, ArchSpec) else None
    cfg = spec.model if spec is not None else spec_or_cfg
    if isinstance(cfg, TransformerConfig):
        from repro_torch.models.transformer import LM
        return LM(cfg, device=device, generator=generator)
    if isinstance(cfg, GNNConfig):
        from repro_torch.models.gnn import build_gnn
        if d_in is None:
            if spec is None:
                raise ValueError("build_model: a GNNConfig needs d_in")
            d_in = next(iter(spec.shapes.values())).d_feat
        return build_gnn(cfg, d_in, cfg.n_classes if n_out is None
                         else n_out, device=device, generator=generator)
    if isinstance(cfg, RecsysConfig):
        from repro_torch.models.recsys.autoint import AutoInt
        return AutoInt(cfg, device=device, generator=generator)
    raise TypeError(f"unknown model config type: {type(cfg)}")
