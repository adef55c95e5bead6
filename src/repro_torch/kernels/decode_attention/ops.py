"""Decode attention wrapper: the CUDA kernels
(``csrc/decode_attention.cu``: the chunk pass and the combine) for tensors
on the card, the plain version (``ref.py``) for tensors on the CPU.

The kernel cuts each batch row's visible keys [0, pos[b]] (``pos`` read on
the card) into chunks of ``CHUNK_KEYS`` keys, one block a chunk and key
head, so the work follows the positions: the reference's Pallas kernel cut
the whole cache into ``n_splits`` equal splits (one split where ``n_splits
* block_s`` did not divide S) and masked the keys past pos; neither number
has a counterpart here.  The wrapper allocates the chunks' float32
partials (m, l, acc) as scratch.  Any D and Dv up to ``MAX_HEAD_DIM`` and
any number of query heads per key head run the kernel, read in place;
wider heads raise, on the CPU as on the card.  ``pos`` must be >= 0.

On a ``meta`` tensor it returns an empty output of the kernel's shape and
dtype and runs neither the kernel nor the plain version.  While an
operation count runs (``launch/op_analysis.py``) a call on the card or on
meta records its function's ``work``."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import (LaunchCounter, check_launch,
                                      counting_work, load, record_work)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import DTYPES, MAX_HEAD_DIM

#: keys a block of the chunk pass reads (a multiple of 64): 1,024 was the
#: fastest of 512-2,048 on an H100 at the LM's decode shapes
CHUNK_KEYS = 1024

launches = LaunchCounter("decode_attention")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _P]}


def work(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         pos: torch.Tensor) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``decode_attention``: the function depends on
    the cache rows at positions <= pos only, a key row and a value row a
    key head (2D + 2Dv operations a query head), plus q read, the output
    written and pos read once.  The visible rows are read from ``pos``
    (a host sync on the card); on meta, with no positions, every row of
    the cache counts."""
    b, _, h, d = q.shape
    s, kvh, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    if pos.device.type == "meta":
        vis = float(b * s)
    else:
        vis = float(torch.clamp(pos.long() + 1, max=s).sum())
    n_bytes = (vis * kvh * (d + dv) + b * h * (d + dv)) * q.element_size() \
        + 4 * b
    return vis * 2.0 * h * (d + dv), float(n_bytes)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, H, D]; k_cache [B, S, KVH, D], v_cache [B, S, KVH, Dv];
    pos [B] int -> [B, 1, H, Dv] in q's dtype.  Keys at positions > pos[b]
    are masked."""
    b, one, h, d = q.shape
    if one != 1 or k_cache.dim() != 4 or v_cache.dim() != 4 \
            or v_cache.shape[:3] != k_cache.shape[:3] \
            or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or h % k_cache.shape[2] != 0 or tuple(pos.shape) != (b,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)} do not fit")
    if max(d, v_cache.shape[3]) > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head widths D={d}, "
                         f"Dv={v_cache.shape[3]} past {MAX_HEAD_DIM} are not "
                         f"served")
    scale = scale if scale is not None else d ** -0.5
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, pos)):
        return decode_attention_ref(q, k_cache, v_cache, pos, scale=scale)
    if counting_work():
        record_work("decode_attention", work(q, k_cache, v_cache, pos))
    if q.device.type == "meta":
        return q.new_empty(b, 1, h, v_cache.shape[3])
    return _launch(q, k_cache, v_cache, pos, scale)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: torch.Tensor, scale: float) -> torch.Tensor:
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
    s, kvh, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[3]
    g = h // kvh
    out = q.new_empty(b, 1, h, dv)
    if s == 0:
        # no key to weigh: the plain version's acc / 1e-30 = 0
        return out.zero_()
    chunks = -(-s // CHUNK_KEYS)
    lib = load("decode_attention", _SIGNATURES)
    m = torch.empty((b * kvh, chunks, g), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b * kvh, chunks, g, dv), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            out.data_ptr(), b, s, kvh, g, d, dv, DTYPES[q.dtype], CHUNK_KEYS,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("decode_attention", err)
    launches.add()
    return out
