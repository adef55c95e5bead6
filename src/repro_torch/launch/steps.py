"""The LM's serving step functions: the reference's ``prefill_step`` and
``serve_step`` (``launch/steps.py``) without meshes, shardings or abstract
shapes -- one card runs them eagerly, for every LM config (dense, MoE,
MLA).  The training step and the dry-run lowering wait for their slices
(ROADMAP Queue A)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.transformer import LM, Cache


def prefill_step(model: LM, tokens) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] -> (last-position logits [B, V], cache of S)."""
    return model.prefill(tokens)


def serve_step(model: LM, cache: Cache, tokens, pos
               ) -> Tuple[torch.Tensor, Cache]:
    """One new token per row: tokens [B, 1], pos [B] -> (logits [B, V],
    cache).  The cache is updated in place."""
    return model.decode_step(cache, tokens, pos)
