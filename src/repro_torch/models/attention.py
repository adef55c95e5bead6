"""Attention: flash-style causal attention for prefill, grouped decode.

The reference's ``models/attention.py`` with its [B, S, H, D] layout.  On
the card both functions are the hand-written kernels
(``kernels/flash_attention``, ``kernels/decode_attention``); on the CPU
their plain versions, which repeat the reference's arithmetic.

* ``chunked_attention`` -- online softmax over KV blocks; never builds the
  Sq x Skv score matrix.  k and v may hold fewer heads than q (GQA): the
  kernel reads key head h // (H / KVH), so no ``repeat_kv`` copy is made.
  v may have its own width Dv (MLA's prefill), and q may be shorter or
  longer than k and v (its rows right-aligned, as the reference does).
* ``decode_attention`` -- one query token against the KV cache, masked past
  ``pos``; the cache is read once for the G query heads of each key head.

``chunked_attention`` takes a causal ``window`` (a sliding-window layer's
band, ``kernels/flash_attention``); a windowed call that wants a gradient
raises: no backward weighs a band.

Both serve head widths up to 256 and raise past them.

``chunked_attention`` is differentiable: where a gradient is wanted it runs
as a ``torch.autograd.Function`` whose forward keeps the softmax's row
statistics (m, l) beside q, k, v and the output, and whose backward is
``flash_attention_bwd`` -- the hand-written backward kernel on the card,
its plain version on the CPU.  The backward is the gradient of the
float32-weight attention; with ``bf16_probs`` the forward rounds its
weights and the backward recomputes them unrounded.  ``decode_attention``
serves only and takes no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention as _decode_kernel,
)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, KVH * n_rep, D] (GQA broadcast)."""
    if n_rep == 1:
        return k
    b, s, kvh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kvh, n_rep, d).reshape(
        b, s, kvh * n_rep, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, block_kv: int = 1024,
                      scale: Optional[float] = None,
                      bf16_probs: bool = False, window: int = 0
                      ) -> torch.Tensor:
    """q [B, Sq, H, D]; k [B, Skv, KVH, D], v [B, Skv, KVH, Dv] ->
    [B, Sq, H, Dv].  Query row i sits at position i + Skv - Sq (causal masks
    the keys past it, a ``window`` w those w or more behind it).  fp32
    accumulation; ``bf16_probs`` rounds the softmax weights to bf16 before
    P.V."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if window:
            raise NotImplementedError("chunked_attention: no gradient of a "
                                      "windowed attention")
        return _FlashAttention.apply(q, k, v, causal, scale, bf16_probs,
                                     block_kv)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           bf16_probs=bf16_probs, block_kv=block_kv,
                           window=window)


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with ``flash_attention_bwd`` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bf16_probs, block_kv):
        out, m, l = flash_attention(q, k, v, causal=causal, scale=scale,
                                    bf16_probs=bf16_probs, block_kv=block_kv,
                                    return_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, scale, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, scale, block_kv = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l, dout,
                                         causal=causal, scale=scale,
                                         block_kv=block_kv)
        return dq, dk, dv, None, None, None, None


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, H, D]; k_cache [B, S, KVH, D], v_cache [B, S, KVH, Dv]; pos
    [B] (index of the new token) -> [B, 1, H, Dv], keys past ``pos``
    masked."""
    return _decode_kernel(q, k_cache, v_cache, pos, scale=scale)
