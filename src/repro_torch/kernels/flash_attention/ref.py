"""Plain PyTorch version of causal flash attention: the arithmetic of the
reference's ``chunked_attention`` (``models/attention.py``), which the
Pallas ``flash_attention_pallas`` kernel replaces on a TPU.

An online softmax (running max m, sum l, accumulator acc, all fp32) over
key blocks of ``block_kv``, so the S x S score matrix is never built.
Masked scores are -1e30, not -inf, so a fully masked block keeps a finite
max; l is floored at 1e-30 and the output is in q's dtype.  k and v may
hold fewer heads than q (grouped-query attention): query head h reads key
head h // (H / KVH), as ``repeat_kv`` would lay it out.  Any S runs: the
last block is shorter when S is not a multiple of ``block_kv``.

The CPU path and the tests use it; a tensor on the card goes to the CUDA
kernel instead."""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1.0e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        bf16_probs: bool = False, block_kv: int = 1024
                        ) -> torch.Tensor:
    """q [B, S, H, D]; k, v [B, S, KVH, D] with KVH dividing H ->
    [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    block_kv = max(1, min(block_kv, s))
    qf = (q.float() * scale).permute(0, 2, 1, 3)              # [B,H,S,D]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    q_pos = torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for start in range(0, s, block_kv):
        stop = min(start + block_kv, s)
        sc = torch.matmul(qf, kf[:, :, start:stop].transpose(-1, -2))
        if causal:
            k_pos = torch.arange(start, stop, device=q.device)
            sc = sc.masked_fill(q_pos[:, None] < k_pos[None, :], NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if bf16_probs:
            # softmax weights rounded to bf16; products and sums stay fp32
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.matmul(p, vf[:, :, start:stop])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
