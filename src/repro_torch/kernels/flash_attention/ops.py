"""Flash attention wrapper: the CUDA kernel (``csrc/flash_attention.cu``)
for tensors on the card, the plain version (``ref.py``) for tensors on the
CPU.

Any Skv runs the kernel: the reference's dispatcher sent an S that its
block does not divide to ``chunked_attention``; here the kernel masks its
ragged last tile.  k and v may hold fewer heads than q (grouped-query
attention); the kernel reads key head h // (H / KVH) in place.  q may be
shorter or longer than k and v (query row i at position i + Skv - Sq, as
the reference right-aligns it), and v may have its own width Dv.

The kernel is compiled for the (D, Dv) pairs of ``HEAD_DIMS``; any other
pair up to ``MAX_HEAD_DIM`` is zero-padded to the smallest compiled pair
that holds it (zero columns leave q . k unchanged; the output's padded
columns are cut off) with the scale of the true D.  Wider heads raise, on
the CPU as on the card."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: (D, Dv) pairs the kernel is compiled for: equal widths, and MLA's
#: prefill (q and k at 128 + 64, v at 128)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (160, 160),
             (192, 192), (256, 256), (192, 128))
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter("flash_attention")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _P],
               "flash_attention_key_tile": [_I, _I, _I]}


def compiled_dims(d: int, dv: int) -> Tuple[int, int]:
    """The smallest compiled (D, Dv) pair that holds (d, dv)."""
    fits = [p for p in HEAD_DIMS if p[0] >= d and p[1] >= dv]
    if d < 1 or dv < 1 or not fits:
        raise ValueError(f"flash_attention: head widths D={d}, Dv={dv} not "
                         f"served (each must be 1..{MAX_HEAD_DIM})")
    return min(fits, key=lambda p: (p[0] + p[1], p))


def key_tile(d: int, dtype: torch.dtype = torch.bfloat16,
             dv: Optional[int] = None) -> int:
    """Keys per tile of the kernel for ``dtype`` at head widths ``d`` and
    ``dv`` (default ``d``; the CUDA library's own number, so the card must
    be there).  With ``bf16_probs`` each tile's weights are rounded to bf16
    on that tile's running max, so the plain version rounds alike at
    ``block_kv=key_tile(d, dtype, dv)`` (both are the reference's chunked
    rounding, at another block)."""
    dp, dvp = compiled_dims(d, d if dv is None else dv)
    return load("flash_attention", _SIGNATURES).flash_attention_key_tile(
        dp, dvp, DTYPES[dtype])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    bf16_probs: bool = False, block_kv: int = 1024
                    ) -> torch.Tensor:
    """q [B, Sq, H, D]; k [B, Skv, KVH, D], v [B, Skv, KVH, Dv], KVH
    dividing H -> [B, Sq, H, Dv] in q's dtype.  ``block_kv`` is the plain
    version's key block; the kernel's tile is fixed."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   bf16_probs=bf16_probs, block_kv=block_kv)
    return _launch(q, k, v, causal, scale, bf16_probs)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q [B,Sq,H,D], k [B,Skv,KVH,D] and"
                         f" v [B,Skv,KVH,Dv] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (KVH must divide H)")
    compiled_dims(d, v.shape[3])


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
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if sq == 0 or skv == 0:
        # no query, or no key to weigh: the plain version's acc / 1e-30 = 0
        return q.new_zeros(b, sq, h, dv)
    dp, dvp = compiled_dims(d, dv)
    if dp != d:
        q, k = F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d))
    if dvp != dv:
        v = F.pad(v, (0, dvp - dv))
    out = q.new_empty(b, sq, h, dvp)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: bf16 tensors must start on a "
                         "16-byte boundary (the kernel loads 16 bytes at once)")
    lib = load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, h, kvh, dp, dvp, DTYPES[q.dtype], float(scale), int(causal),
            int(bf16_probs), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    launches.add()
    return out if dvp == dv else out[..., :dv].contiguous()
