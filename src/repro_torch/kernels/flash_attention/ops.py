"""Flash attention wrapper: the CUDA kernel (``csrc/flash_attention.cu``)
for tensors on the card, the plain version (``ref.py``) for tensors on the
CPU.

Any S runs the kernel: the reference's dispatcher sent an S that its block
does not divide to ``chunked_attention``; here the kernel masks its ragged
last tile.  k and v may hold fewer heads than q (grouped-query attention);
the kernel reads key head h // (H / KVH) in place."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: head widths the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128, 160)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter("flash_attention")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _P],
               "flash_attention_key_tile": [_I, _I]}


def key_tile(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Keys per tile of the kernel for ``dtype`` at head width ``d`` (the
    CUDA library's own number, so the card must be there).  With
    ``bf16_probs`` each tile's weights are rounded to bf16 on that tile's
    running max, so the plain version rounds alike at
    ``block_kv=key_tile(d, dtype)`` (both are the reference's chunked
    rounding, at another block)."""
    return load("flash_attention", _SIGNATURES).flash_attention_key_tile(
        d, DTYPES[dtype])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    bf16_probs: bool = False, block_kv: int = 1024
                    ) -> torch.Tensor:
    """q [B, S, H, D]; k, v [B, S, KVH, D], KVH dividing H -> [B, S, H, D]
    in q's dtype.  ``block_kv`` is the plain version's key block; the
    kernel's tile is fixed."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   bf16_probs=bf16_probs, block_kv=block_kv)
    return _launch(q, k, v, causal, scale, bf16_probs)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B,S,H,D] and k, v [B,S,KVH,D]"
                         f" expected, got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (KVH must divide H)")
    if k.shape[1] != s:
        raise ValueError(f"flash_attention: Sq={s} != Skv={k.shape[1]}; "
                         f"only self-attention over one sequence is served")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, bf16_probs: bool) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"tensor on q's CUDA device in q's dtype, got "
                             f"{t.device} {t.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: bf16 tensors must start on a "
                         "16-byte boundary (the kernel loads 16 bytes at once)")
    lib = load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
            k.shape[2], d, DTYPES[q.dtype], float(scale), int(causal),
            int(bf16_probs), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    launches.add()
    return out
