"""Shared neural layers: RMSNorm, rotary embeddings, init helpers.

The reference's ``models/layers.py`` with the same float32 casts; random
init draws from an explicit ``torch.Generator`` on the tensor's device."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import YarnRope


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
                   dtype: torch.dtype = torch.float32,
                   yarn: Optional[YarnRope] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE. positions: [...]; returns [..., head_dim/2].
    Under ``yarn`` the frequencies and the cos/sin scale are YaRN's: its
    ``attention_factor`` where given, else m(mscale) / m(mscale_all_dim)
    (``transformers``' rule for both)."""
    half = head_dim // 2
    if yarn is None:
        freqs = torch.exp(-math.log(theta) * torch.arange(
            half, dtype=torch.float32, device=positions.device) / half)
        mscale = 1.0
    else:
        freqs = yarn_inv_freq(yarn, head_dim, theta).to(positions.device)
        mscale = yarn.attention_factor if yarn.attention_factor is not None \
            else yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(
                yarn.factor, yarn.mscale_all_dim)
    angles = positions.float()[..., None] * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos.to(dtype), sin.to(dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale m = 0.1 mscale ln(factor) + 1 (1 at
    factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(yarn: YarnRope, head_dim: int, theta: float
               ) -> Tuple[int, int]:
    """(low, high): the rotary pairs below ``low`` keep their original
    frequency, those from ``high`` on are interpolated, a linear ramp
    between; the dim that turns ``rotations`` times over the original
    context, floored and ceiled, clamped to [0, head_dim - 1]."""
    def dim(rotations: float) -> float:
        return head_dim * math.log(yarn.original_max_position / (
            rotations * 2 * math.pi)) / (2 * math.log(theta))
    return (max(math.floor(dim(yarn.beta_fast)), 0),
            min(math.ceil(dim(yarn.beta_slow)), head_dim - 1))


def yarn_inv_freq(yarn: YarnRope, head_dim: int, theta: float
                  ) -> torch.Tensor:
    """[head_dim / 2] float32 frequencies: f_inter (1 - mask) + f_extra
    mask, f_extra = theta^(-2i / head_dim), f_inter = f_extra / factor,
    mask = 1 - clamp((i - low) / (high - low), 0, 1)."""
    extra = 1.0 / theta ** (torch.arange(0, head_dim, 2,
                                         dtype=torch.float32) / head_dim)
    inter = extra / yarn.factor
    low, high = yarn_range(yarn, head_dim, theta)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32)
                        - low) / max(high - low, 1e-3), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def yarn_softmax_scale(yarn: Optional[YarnRope], qk_dim: int) -> float:
    """The attention's softmax scale: qk_dim^-1/2, times
    m(mscale_all_dim)^2 under YaRN with ``mscale_all_dim`` set."""
    scale = qk_dim ** -0.5
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


def interleaved_pairs(x: torch.Tensor) -> torch.Tensor:
    """x's last dim as DeepSeek's rope reads it: pairs (0, 1), (2, 3), ...
    moved to (i, i + D/2), so :func:`apply_rotary` rotates them."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


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
