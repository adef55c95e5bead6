"""build_model: ArchSpec or config -> model object."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchSpec, TransformerConfig
from repro_torch.device import DeviceLike


def build_model(spec_or_cfg: Any, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """The model of an ArchSpec or a config, on ``device`` (default: the
    CUDA card).  Every ``TransformerConfig`` (dense, MoE, MLA) builds an
    ``LM``; GNN and recsys configs come with their modules (ROADMAP
    Queue A)."""
    cfg = spec_or_cfg.model if isinstance(spec_or_cfg, ArchSpec) \
        else spec_or_cfg
    if isinstance(cfg, TransformerConfig):
        from repro_torch.models.transformer import LM
        return LM(cfg, device=device, generator=generator)
    raise TypeError(f"model config type not ported: {type(cfg)}")
