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
the CPU as on the card.

``flash_attention_bwd`` is the gradient: the CUDA kernel of
``csrc/flash_attention_bwd.cu`` on the card, ``flash_attention_bwd_ref``
on the CPU.  It takes the forward's row statistics m and l, which
``flash_attention(..., return_stats=True)`` returns beside the output, and
serves every shape the forward serves, padded alike.

On a ``meta`` tensor both return empty outputs of the kernel's shapes and
dtypes and run neither the kernel nor the plain version.  While an
operation count runs (``launch/op_analysis.py``) a call on the card or on
meta records its function's ``work`` (``bwd_work``).

On ``DTensor``s both run on this rank's shards (``kernels/sharded.py``):
the batch and the heads may be sharded, any other dim is gathered
explicitly; where q's heads are sharded and k's are whole, each rank
reads the key heads of its query heads, and their gradient is a partial
sum over those mesh dims."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import sharded
from repro_torch.kernels.build import (LaunchCounter, check_launch,
                                      counting_work, load, record_work)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

#: (D, Dv) pairs the kernel is compiled for: equal widths, and MLA's
#: prefill (q and k at 128 + 64, v at 128)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (160, 160),
             (192, 192), (256, 256), (192, 128))
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter("flash_attention")
bwd_launches = LaunchCounter("flash_attention_bwd")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _F, _I, _I, _P],
               "flash_attention_key_tile": [_I, _I, _I]}
_BWD_SIGNATURES = {"flash_attention_bwd": [_P] * 13 + [_I] * 8
                   + [_F, _I, _P],
                   "flash_attention_bwd_layout": [_I, _I, _P]}
_BWD_LAYOUT = ("keys_per_block", "query_rows_per_step", "stages",
               "smem_bytes", "threads", "split_dk_dv")


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


def bwd_layout(d: int, dv: int) -> dict:
    """The bf16 backward kernel's layout at the compiled pair holding
    (d, dv), from the CUDA library (the card must be there): keys a block,
    query rows a step, stages of its Q / dO ring, dynamic shared memory
    bytes, threads a block, and whether its two consumer warpgroups split
    dK and dV over the same keys."""
    dp, dvp = compiled_dims(d, dv)
    out = (ctypes.c_int * len(_BWD_LAYOUT))()
    err = load("flash_attention_bwd", _BWD_SIGNATURES
               ).flash_attention_bwd_layout(dp, dvp, out)
    check_launch("flash_attention_bwd_layout", err)
    return dict(zip(_BWD_LAYOUT, out), d=dp, dv=dvp)


def attention_pairs(b: int, h: int, sq: int, skv: int, causal: bool
                    ) -> float:
    """The (query, key) pairs attention weighs: every pair unmasked; under
    ``causal`` query row i sits at position i + Skv - Sq and sees the keys
    up to it (a row at a negative position sees none)."""
    if not causal:
        return float(b * h) * sq * skv
    if sq <= skv:
        return float(b * h) * (sq * (skv - sq) + sq * (sq + 1) / 2)
    return float(b * h) * skv * (skv + 1) / 2


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         causal: bool = True) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``flash_attention``: 2D operations for each
    weighed pair's score and 2Dv for its share of P.V; q, k, v read once,
    the output written once."""
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    flops = attention_pairs(b, h, sq, skv, causal) * 2 * (d + dv)
    n_bytes = (b * sq * h * (d + dv) + b * skv * kvh * (d + dv)) \
        * q.element_size()
    return flops, float(n_bytes)


def bwd_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = True) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``flash_attention_bwd``: five products over
    the weighed pairs (S and dS^T q at D, dP and P^T dO at Dv, dS K at D);
    q, k, v, o, dO and the float32 row statistics m, l read once, dq, dk,
    dv written once."""
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    flops = attention_pairs(b, h, sq, skv, causal) * 2 * (3 * d + 2 * dv)
    n_bytes = 2 * (b * sq * h * (d + 2 * dv) + b * skv * kvh * (d + dv)) \
        * q.element_size() + b * h * sq * 8
    return flops, float(n_bytes)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    bf16_probs: bool = False, block_kv: int = 1024,
                    return_stats: bool = False):
    """q [B, Sq, H, D]; k [B, Skv, KVH, D], v [B, Skv, KVH, Dv], KVH
    dividing H -> [B, Sq, H, Dv] in q's dtype; with ``return_stats`` also
    the row statistics (m, l), each [B, H, Sq] float32, as
    ``flash_attention_ref`` defines them.  ``block_kv`` is the plain
    version's key block; the kernel's tile is fixed."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if sharded.is_dtensor(q, k, v):
        return _on_shards(q, k, v, causal, scale, bf16_probs, block_kv,
                          return_stats)
    if _on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   bf16_probs=bf16_probs, block_kv=block_kv,
                                   return_stats=return_stats)
    if counting_work():
        record_work("flash_attention", work(q, k, v, causal))
    if q.device.type == "meta":
        b, sq, h, _ = q.shape
        out = q.new_empty(b, sq, h, v.shape[3])
        if not return_stats:
            return out
        m = torch.empty((b, h, sq), dtype=torch.float32, device="meta")
        return out, m, torch.empty_like(m)
    return _launch(q, k, v, causal, scale, bf16_probs, return_stats)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        do: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None, block_kv: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention`` (its float32 weights): q, k, v as
    there, o [B, Sq, H, Dv] its output, (m, l) [B, H, Sq] its row
    statistics, do [B, Sq, H, Dv] the gradient of o -> (dq, dk, dv) in q's,
    k's and v's dtypes.  ``block_kv`` is the plain version's key block.
    On the card in bf16, dq's float32 sums are added in no fixed order, so
    its last bits may differ from run to run; dk and dv do not."""
    _check_shapes(q, k, v)
    b, sq, h, _ = q.shape
    dv_w = v.shape[3]
    for name, t, shape in (("o", o, (b, sq, h, dv_w)),
                           ("do", do, (b, sq, h, dv_w)),
                           ("m", m, (b, h, sq)), ("l", l, (b, h, sq))):
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if sharded.is_dtensor(q, k, v, o, m, l, do):
        return _bwd_on_shards(q, k, v, o, m, l, do, causal, scale, block_kv)
    if _on_cpu(q, k, v, o, m, l, do):
        return flash_attention_bwd_ref(q, k, v, o, m, l, do, causal=causal,
                                       scale=scale, block_kv=block_kv)
    if counting_work():
        record_work("flash_attention_bwd", bwd_work(q, k, v, causal))
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _launch_bwd(q, k, v, o, m, l, do, causal, scale)


#: q's dims -> the row statistics' [B, H, Sq]
_STATS_DIMS = {0: 0, 2: 1}


def _local_kv(q, k, v):
    """The local k and v, cut to the key heads this rank's query heads
    read (``sharded.kv_heads_of``)."""
    heads = sharded.kv_heads_of(q, k)
    kl, vl = k.to_local(), v.to_local()
    if heads != slice(0, kl.shape[2]):
        kl, vl = kl[:, :, heads].contiguous(), vl[:, :, heads].contiguous()
    return kl, vl, heads


def _on_shards(q, k, v, causal, scale, bf16_probs, block_kv, return_stats):
    """``flash_attention`` on DTensors: each rank's query rows and heads
    against their keys."""
    q, k, v = sharded.attention_inputs(q, k, v)
    kl, vl, _ = _local_kv(q, k, v)
    res = flash_attention(q.to_local(), kl, vl, causal=causal, scale=scale,
                          bf16_probs=bf16_probs, block_kv=block_kv,
                          return_stats=return_stats)
    b, sq, h, _ = q.shape
    out_shape = (b, sq, h, v.shape[3])
    if not return_stats:
        return sharded.wrap(res, q, q.placements, out_shape)
    out, m, l = res
    st = sharded.mapped(q.placements, _STATS_DIMS)
    return (sharded.wrap(out, q, q.placements, out_shape),
            sharded.wrap(m, q, st, (b, h, sq)),
            sharded.wrap(l, q, st, (b, h, sq)))


def _bwd_on_shards(q, k, v, o, m, l, do, causal, scale, block_kv):
    """``flash_attention_bwd`` on DTensors, placed as the forward was: dq
    as q; dk and dv as k and v, partial sums where q's heads are sharded
    and theirs are not."""
    q, k, v = sharded.attention_inputs(q, k, v)
    o = sharded.to(o, q.placements)
    do = sharded.to(do, q.placements)
    st = sharded.mapped(q.placements, _STATS_DIMS)
    m, l = sharded.to(m, st), sharded.to(l, st)
    kl, vl, heads = _local_kv(q, k, v)
    dq, dk, dv = flash_attention_bwd(
        q.to_local(), kl, vl, o.to_local(), m.to_local(), l.to_local(),
        do.to_local(), causal=causal, scale=scale, block_kv=block_kv)
    if dk.shape != k.to_local().shape:
        full_k, full_v = k.to_local(), v.to_local()
        dk = torch.zeros_like(full_k).index_copy_(
            2, torch.arange(heads.start, heads.stop, device=dk.device), dk)
        dv = torch.zeros_like(full_v).index_copy_(
            2, torch.arange(heads.start, heads.stop, device=dv.device), dv)
    gp = sharded.kv_grad_placements(q, k)
    return (sharded.wrap(dq, q, q.placements, tuple(q.shape)),
            sharded.wrap(dk, k, gp, tuple(k.shape)),
            sharded.wrap(dv, v, gp, tuple(v.shape)))


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


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


def _check_card(fn: str, **tensors: torch.Tensor) -> None:
    """Every tensor contiguous on q's CUDA device in q's dtype (float32 for
    the row statistics m, l)."""
    q = tensors["q"]
    for name, t in tensors.items():
        want = torch.float32 if name in ("m", "l") else q.dtype
        if not t.is_cuda or t.device != q.device or t.dtype != want \
                or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous tensor on "
                             f"q's CUDA device in {want}, got {t.device} "
                             f"{t.dtype}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{fn}: dtype {q.dtype} not in {list(DTYPES)}")


def _check_aligned(fn: str, *tensors: torch.Tensor) -> None:
    if tensors[0].dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{fn}: bf16 tensors must start on a 16-byte "
                         "boundary (the kernel loads 16 bytes at once)")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, bf16_probs: bool, return_stats: bool = False):
    _check_card("flash_attention", q=q, k=k, v=v)
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if sq == 0 or skv == 0:
        # no query, or no key to weigh: the plain version's acc / 1e-30 = 0
        out = q.new_zeros(b, sq, h, dv)
        stats = (torch.full((b, h, sq), -1.0e30, device=q.device),
                 torch.zeros((b, h, sq), device=q.device))
        return (out, *stats) if return_stats else out
    dp, dvp = compiled_dims(d, dv)
    if dp != d:
        q, k = F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d))
    if dvp != dv:
        v = F.pad(v, (0, dvp - dv))
    out = q.new_empty(b, sq, h, dvp)
    _check_aligned("flash_attention", q, k, v, out)
    m = l = None
    if return_stats:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    lib = load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if m is None else m.data_ptr(), 0 if l is None else l.data_ptr(),
            b, sq, skv, h, kvh, dp, dvp, DTYPES[q.dtype], float(scale),
            int(causal), int(bf16_probs),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    launches.add()
    out = out if dvp == dv else out[..., :dv].contiguous()
    return (out, m, l) if return_stats else out


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                do: torch.Tensor, causal: bool, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    do = do.contiguous()
    _check_card("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do, m=m, l=l)
    b, sq, h, d = q.shape
    skv, kvh, dv = k.shape[1], k.shape[2], v.shape[3]
    if sq == 0 or skv == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dp, dvp = compiled_dims(d, dv)
    if dp != d:
        q, k = F.pad(q, (0, dp - d)), F.pad(k, (0, dp - d))
    if dvp != dv:
        v, o, do = (F.pad(t, (0, dvp - dv)) for t in (v, o, do))
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, sq), **f32)
    stats = dq_accum = None
    if q.dtype == torch.bfloat16:
        # each query tile's packed row statistics, and dq's float32 sums,
        # which the kernel adds to by TMA reductions (or atomics)
        rows = bwd_layout(dp, dvp)["query_rows_per_step"]
        stats = torch.empty(b * h * -(-sq // rows) * 3 * rows, **f32)
        dq_accum = torch.zeros((b, sq, h, dp), **f32)
    _check_aligned("flash_attention_bwd", q, k, v, o, do, dq, dk, dvv)
    lib = load("flash_attention_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
            0 if stats is None else stats.data_ptr(),
            0 if dq_accum is None else dq_accum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, sq, skv, h,
            kvh, dp, dvp, DTYPES[q.dtype], float(scale), int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention_bwd", err)
    bwd_launches.add()
    if dp != d:
        dq, dk = dq[..., :d].contiguous(), dk[..., :d].contiguous()
    if dvp != dv:
        dvv = dvv[..., :dv].contiguous()
    return dq, dk, dvv
