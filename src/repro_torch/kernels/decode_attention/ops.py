"""Decode attention wrapper: the CUDA kernels
(``csrc/decode_attention.cu``: the split-K pass and the combine) for
tensors on the card, the plain version (``ref.py``) for tensors on the CPU.

The wrapper allocates the splits' float32 partials (m, l, acc) as scratch.
Any cache length runs the kernel: the reference's Pallas path dropped to one
split when ``n_splits * block_s`` did not divide S.  The kernel's splits cut
each row's visible keys [0, pos[b]] (read on the card), so the last split is
shorter where ``n_splits`` does not divide them; the reference's ``block_s``
has no counterpart (each warp streams its split four keys at a time).
``pos`` must be >= 0."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import LaunchCounter, check_launch, load
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import DTYPES, HEAD_DIMS

MAX_GROUP = 8     # query heads per key head the kernel holds

launches = LaunchCounter("decode_attention")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _P]}


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     n_splits: int = 8, scale: Optional[float] = None
                     ) -> torch.Tensor:
    """q [B, 1, H, D]; caches [B, S, KVH, D]; pos [B] int -> [B, 1, H, D]
    in q's dtype.  Keys at positions > pos[b] are masked."""
    b, one, h, d = q.shape
    if one != 1 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or h % k_cache.shape[2] != 0 or tuple(pos.shape) != (b,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)} do not fit")
    scale = scale if scale is not None else d ** -0.5
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, pos)):
        return decode_attention_ref(q, k_cache, v_cache, pos, scale=scale)
    return _launch(q, k_cache, v_cache, pos, n_splits, scale)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: torch.Tensor, n_splits: int, scale: float) -> torch.Tensor:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_cuda or t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"tensor on q's CUDA device in q's dtype, got "
                             f"{t.device} {t.dtype}")
    if not pos.is_cuda or pos.device != q.device or pos.dtype != torch.int32:
        raise ValueError(f"decode_attention: pos must be int32 on "
                         f"{q.device}, got {pos.device} {pos.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {d} not in {HEAD_DIMS}"
                         f" or {g} query heads per key head > {MAX_GROUP}")
    n_splits = max(1, n_splits)
    lib = load("decode_attention", _SIGNATURES)
    m = torch.empty((b * kvh, n_splits, g), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b * kvh, n_splits, g, d), dtype=torch.float32,
                      device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            out.data_ptr(), b, s, kvh, g, d, DTYPES[q.dtype], n_splits,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    launches.add()
    return out
