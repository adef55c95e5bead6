"""Shared neural layers: RMSNorm, rotary embeddings, init helpers.

The reference's ``models/layers.py`` with the same float32 casts; random
init draws from an explicit ``torch.Generator`` on the tensor's device."""
from __future__ import annotations

import math
from typing import Tuple

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
             fused: bool = False) -> torch.Tensor:
    """RMSNorm.  Default: fp32 intermediate (reference numerics).

    ``fused=True`` (the 'fused_norm' variant): the fp32 square feeds the
    reduction and the rescale happens in the input dtype, so no full-width
    fp32 copy of x is kept, at the cost of a multiply rounded in x's dtype."""
    if fused:
        var = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * scale.to(x.dtype)
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE. positions: [...]; returns [..., head_dim/2]."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """Rotate pairs (split-half convention). x: [B, S, H, D]; cos/sin:
    [B?, S, D/2].  The rotation runs in fp32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()

    # insert the head axis at -2, then left-pad batch axes
    def _expand(c):
        c = c[..., None, :]
        while c.dim() < x.dim():
            c = c[None]
        return c

    cos, sin = _expand(cos), _expand(sin)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


def dense_init_(out: torch.Tensor, in_axis_size: int,
                generator: torch.Generator) -> torch.Tensor:
    """Truncated-normal fan-in init into ``out``, in place: a standard normal
    cut at +-2, times fan_in^-1/2, drawn in fp32 on ``out``'s device."""
    std = 1.0 / math.sqrt(max(1, in_axis_size))
    t = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.copy_(t.mul_(std))


def embed_init_(out: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    """0.02 * standard normal into ``out``, in place."""
    t = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    t.normal_(generator=generator)
    return out.copy_(t.mul_(0.02))
