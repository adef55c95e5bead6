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
meta records its function's ``work``.

On ``DTensor``s it runs on this rank's shards (``kernels/sharded.py``):
batch rows and heads as the flash wrapper places them, and a cache whose
positions are sharded (the decode rules' ``kv_seq``) is not gathered:
each rank weighs its own positions, keeps its rows' log-sum-exp beside
its output (from the kernel's chunk partials on the card), and the ranks'
partial softmaxes are combined with an all-reduce of the max and one of
(weighted output, weight) over the position-sharding mesh dims: the
flash-decoding combine of ``distributed/collectives.py``'s
``partial_softmax_combine``."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import sharded
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
    if sharded.is_dtensor(q, k_cache, v_cache, pos):
        return _on_shards(q, k_cache, v_cache, pos, scale)
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, pos)):
        return decode_attention_ref(q, k_cache, v_cache, pos, scale=scale)
    if counting_work():
        record_work("decode_attention", work(q, k_cache, v_cache, pos))
    if q.device.type == "meta":
        return q.new_empty(b, 1, h, v_cache.shape[3])
    return _launch(q, k_cache, v_cache, pos, scale)


def _on_shards(q, k_cache, v_cache, pos, scale):
    """``decode_attention`` on DTensors (the module docstring)."""
    from repro_torch.kernels.flash_attention.ops import _local_kv

    q, k_cache, v_cache = sharded.attention_inputs(q, k_cache, v_cache,
                                                   kv_seq=True)
    pos = sharded.follow(pos, q, {0: 0})
    kl, vl, _ = _local_kv(q, k_cache, v_cache)
    b, _, h, _ = q.shape
    out_shape = (b, 1, h, v_cache.shape[3])
    ql, pl = q.to_local(), pos.to_local()
    seq_dims = sharded.sharded_over(k_cache, 1)
    if not seq_dims:
        out = decode_attention(ql, kl, vl, pl, scale=scale)
        return sharded.wrap(out, q, q.placements, out_shape)
    local = pl - sharded.offset(k_cache, 1)
    seen = local >= 0                    # the rank holds a visible key
    out, lse = _with_lse(ql, kl, vl, torch.where(seen, local, 0).to(
        pl.dtype), scale)
    lse = torch.where(seen[:, None], lse, float("-inf"))
    out = _combine(out, lse, k_cache.device_mesh, seq_dims)
    return sharded.wrap(out, q, q.placements, out_shape)


def _with_lse(q, k_cache, v_cache, pos, scale):
    """``decode_attention`` of local tensors and each (row, head)'s
    log-sum-exp of its weighed scores [B, H] float32 (natural log)."""
    b, _, h, d = q.shape
    if q.device.type == "meta":
        out = decode_attention(q, k_cache, v_cache, pos, scale=scale)
        return out, torch.empty((b, h), dtype=torch.float32, device="meta")
    if q.is_cuda:
        if counting_work():
            record_work("decode_attention", work(q, k_cache, v_cache, pos))
        return _launch(q, k_cache, v_cache, pos, scale, with_lse=True)
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = (q.float() * scale).reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    return (decode_attention_ref(q, k_cache, v_cache, pos, scale=scale),
            torch.logsumexp(scores, dim=-1).reshape(b, h))


def _combine(out, lse, mesh, dims):
    """The ranks' partial softmaxes over the mesh dims ``dims`` -> the
    whole one: out [B, 1, H, Dv] each rank's normalised output, lse [B, H]
    its log-sum-exp (-inf where it weighed nothing)."""
    from torch.distributed import _functional_collectives as funcol

    mx = lse
    for i in dims:
        mx = funcol.all_reduce(mx, "max", (mesh, i))
    w = torch.exp(lse - mx)                               # [B, H]
    num = torch.where(w[:, None, :, None] > 0, out.float(), 0.0) \
        * w[:, None, :, None]
    both = torch.cat([num[:, 0], w[..., None]], dim=-1)   # [B, H, Dv + 1]
    for i in dims:
        both = funcol.all_reduce(both, "sum", (mesh, i))
    res = both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-30)
    return res[:, None].to(out.dtype)


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            pos: torch.Tensor, scale: float, with_lse: bool = False):
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
        if with_lse:
            return out.zero_(), torch.full((b, h), float("-inf"),
                                           device=q.device)
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
    if not with_lse:
        return out
    # the row's log-sum-exp from its chunks' (max, sum) in base 2, over the
    # chunks that its visible keys fill (the others are not written)
    n_c = (torch.clamp(pos.long() + 1, max=s) + CHUNK_KEYS - 1) \
        // CHUNK_KEYS
    used = (torch.arange(chunks, device=q.device)[None, :]
            < n_c[:, None]).repeat_interleave(kvh, 0)[..., None]
    m = torch.where(used, m, float("-inf"))
    mx = m.amax(dim=1)
    lsum = (torch.where(used, l, 0.0) * torch.exp2(m - mx[:, None])).sum(1)
    lse = (mx + torch.log2(lsum)) * 0.6931471805599453
    return out, lse.reshape(b, h)
