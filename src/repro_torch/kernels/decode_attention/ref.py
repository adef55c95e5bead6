"""Plain PyTorch version of one-token grouped-query decode attention: the
arithmetic of the reference's ``decode_attention`` (``models/attention.py``)
and its oracle ``decode_attention_ref``, which the Pallas
``decode_attention_pallas`` kernel replaces on a TPU.

Query head h attends to key head h // G (G = H / KVH) over the cache
positions <= ``pos[b]``; later positions score -1e30.  The grouped einsum
reads the cache once (no ``repeat_kv`` copy); v may have its own width Dv,
and G may be any whole number.  The CPU path and the tests
use it; a tensor on the card goes to the CUDA kernel instead."""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1.0e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, H, D]; k_cache [B, S, KVH, D], v_cache [B, S, KVH, Dv];
    pos [B] -> [B, 1, H, Dv]."""
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = (q.float() * scale).reshape(b, kvh, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return ctx.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)
