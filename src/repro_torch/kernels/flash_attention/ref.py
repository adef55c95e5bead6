"""Plain PyTorch version of causal flash attention: the arithmetic of the
reference's ``chunked_attention`` (``models/attention.py``), which the
Pallas ``flash_attention_pallas`` kernel replaces on a TPU.

An online softmax (running max m, sum l, accumulator acc, all fp32) over
key blocks of ``block_kv``, so the Sq x Skv score matrix is never built.
Masked scores are -1e30, not -inf, so a fully masked block keeps a finite
max; l is floored at 1e-30 and the output is in q's dtype.  k and v may
hold fewer heads than q (grouped-query attention): query head h reads key
head h // (H / KVH), as ``repeat_kv`` would lay it out.  v may be narrower
or wider than q and k (Dv != D, as MLA's prefill sends).  q may be shorter
or longer than k and v: as in the reference, query row i sits at position
i + Skv - Sq (right-aligned), so under ``causal`` a row at a negative
position sees no key and its -1e30 scores give every key the same weight.
Any Skv runs: the last block is shorter when Skv is not a multiple of
``block_kv``.

The CPU path and the tests use it; a tensor on the card goes to the CUDA
kernel instead.  ``bf16_probs_slack`` gives the checks of the kernel (the
card tests, ``chip_smoke.py``) the room that ``bf16_probs`` rounding needs
where a weight sits on a midpoint between two bf16 values."""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1.0e30


def _weights(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, scale: Optional[float], block_kv: int):
    """The online softmax's key blocks: yields (p, alpha, v block, m) for
    each, p = exp(score - running max) [B, H, Sq, block] float32, alpha [B,
    H, Sq] the factor that carries what came before onto the new max, and m
    that running max."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    g = h // k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    block_kv = max(1, min(block_kv, skv))
    qf = (q.float() * scale).permute(0, 2, 1, 3)              # [B,H,Sq,D]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)   # right-aligned
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    for start in range(0, skv, block_kv):
        stop = min(start + block_kv, skv)
        sc = torch.matmul(qf, kf[:, :, start:stop].transpose(-1, -2))
        if causal:
            k_pos = torch.arange(start, stop, device=q.device)
            sc = sc.masked_fill(q_pos[:, None] < k_pos[None, :], NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        m = m_new
        yield p, alpha, vf[:, :, start:stop], m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        bf16_probs: bool = False, block_kv: int = 1024,
                        return_stats: bool = False):
    """q [B, Sq, H, D]; k [B, Skv, KVH, D], v [B, Skv, KVH, Dv] with KVH
    dividing H -> [B, Sq, H, Dv] in q's dtype.  With ``return_stats`` also
    the softmax's row statistics, each [B, H, Sq] float32: m, the largest
    scaled score of the row (-1e30 for a row that sees no key), and l, the
    sum of exp(score - m) over the row, so that the weights are
    exp(score - m) / l."""
    b, sq, h, _ = q.shape
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for p, alpha, vb, m in _weights(q, k, v, causal, scale, block_kv):
        l = l * alpha + p.sum(dim=-1)
        if bf16_probs:
            # softmax weights rounded to bf16; products and sums stay fp32
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 2, 1, 3).to(q.dtype)
    return (out, m, l) if return_stats else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, do: torch.Tensor,
                            causal: bool = True,
                            scale: Optional[float] = None,
                            block_kv: int = 1024, p_terms: int = 0,
                            ds_terms: int = 0):
    """The gradient of :func:`flash_attention_ref` (float32 weights):
    q, k, v as there, o [B, Sq, H, Dv] its output, m and l [B, H, Sq] its
    row statistics, do [B, Sq, H, Dv] the gradient of o -> (dq, dk, dv) in
    q's, k's and v's dtypes.  The flash-attention backward, key block by
    key block: the weights recomputed as P = exp(s - m) / l from m and l
    kept apart (a row that sees no key has m = -1e30, which a single
    logsumexp m + log l would round back to -1e30, giving it weights of 1
    where the forward gave 1 / Skv); D = rowsum(dO o) in float32;
    dS = P (dO V^T - D), zero where the mask replaced the score by a
    constant; dq = scale dS K, dk = scale dS^T q, dv = P^T dO.  A key
    head's dk and dv sum over its G query heads.

    ``p_terms`` and ``ds_terms`` (0: float32, the default) round P before
    P^T dO and dS before dS K and dS^T q to that many bf16 terms
    (:func:`bf16_terms`), as the bf16 kernel feeds its tensor cores."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    block_kv = max(1, min(block_kv, skv))
    qf = (q.float() * scale).permute(0, 2, 1, 3)              # [B,H,Sq,D]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    dof = do.float().permute(0, 2, 1, 3)                      # [B,H,Sq,Dv]
    delta = (dof * o.float().permute(0, 2, 1, 3)).sum(dim=-1)  # [B,H,Sq]
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for start in range(0, skv, block_kv):
        stop = min(start + block_kv, skv)
        sc = torch.matmul(qf, kf[:, :, start:stop].transpose(-1, -2))
        masked = None
        if causal:
            k_pos = torch.arange(start, stop, device=q.device)
            masked = q_pos[:, None] < k_pos[None, :]
            sc = sc.masked_fill(masked, NEG)
        p = torch.exp(sc - m[..., None]) / l[..., None]
        dv[:, :, start:stop] = torch.matmul(
            bf16_terms(p, p_terms).transpose(-1, -2), dof)
        ds = p * (torch.matmul(dof, vf[:, :, start:stop].transpose(-1, -2))
                  - delta[..., None])
        if masked is not None:
            ds = ds.masked_fill(masked, 0.0)
        ds = bf16_terms(ds, ds_terms)
        dq += torch.matmul(ds, kf[:, :, start:stop])
        dk[:, :, start:stop] = torch.matmul(ds.transpose(-1, -2), qf)

    def heads(x, width):            # [B, H, S, W] -> [B, S, KVH, W], summed
        return x.reshape(b, kvh, g, -1, width).sum(dim=2).permute(0, 2, 1, 3)

    return ((dq * scale).permute(0, 2, 1, 3).to(q.dtype),
            heads(dk, d).to(k.dtype), heads(dv, v.shape[-1]).to(v.dtype))


def bf16_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """float32 x as the sum of ``terms`` bf16 values, as a kernel feeds a
    float32 operand to bf16 tensor cores: 1 gives bf16(x), 2 gives hi + lo
    with hi = bf16(x), lo = bf16(x - hi) (16 bits of x); 0 leaves x as it
    is."""
    if terms == 0:
        return x
    hi = x.to(torch.bfloat16).float()
    if terms == 1:
        return hi
    if terms == 2:
        return hi + (x - hi).to(torch.bfloat16).float()
    raise ValueError(f"bf16_terms: terms must be 0, 1 or 2, got {terms}")


def bf16_probs_slack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, scale: Optional[float] = None,
                     block_kv: int = 1024, rel: float = 2.0 ** -12
                     ) -> torch.Tensor:
    """How far a kernel's ``bf16_probs`` output may lie from
    ``flash_attention_ref(..., bf16_probs=True, block_kv=block_kv)`` when
    its float32 weights differ from the plain version's by at most ``rel``
    of themselves (float32 noise: scores summed in another order, the scale
    folded into an exp2): [B, Sq, H, Dv] float32.

    Only a weight p within ``rel * p`` of a midpoint between two bf16 values
    can round to the other neighbour, one bf16 ulp away; it moves the output
    by ulp * |v| / l.  The slack is the sum of those moves over every such
    weight, so a limit of atol + rtol |want| + slack still fails a kernel
    that drops a key tile on long rows, where l is large."""
    b, sq, h, _ = q.shape
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    slack = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
    for p, alpha, vb, _ in _weights(q, k, v, causal, scale, block_kv):
        l = l * alpha + p.sum(dim=-1)
        mant, ex = torch.frexp(p)          # p = mant 2^ex, mant in [0.5, 1)
        ulp = torch.ldexp(torch.ones_like(p), ex - 8)   # bf16 keeps 8 bits
        off = ((mant * 256.0).frac() - 0.5).abs() * ulp  # to the midpoint
        flip = torch.where((p > 0) & (off <= rel * p), ulp, 0.0)
        slack = slack * alpha[..., None] + torch.matmul(flip, vb.abs())
    out = slack / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)
