"""Gradient compression for a slow data-parallel link, the reference's
``training/compression.py``.

int8 uniform quantization with one scale a leaf and error feedback (the
1-bit Adam family): the quantization residual is carried to the next step,
so the compressed all-reduce is unbiased over time.  Trees are nested
dicts (or lists, tuples) of tensors.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so the int8 payloads are the reference's byte for
byte.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_reduce_sum
from repro_torch.training.tree import flatten_with_paths, tree_map, unflatten_like


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_one(g: torch.Tensor, e: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    gf = g.float() + e
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compress(grads: Any, error_fb: Any) -> Tuple[Any, Any, Any]:
    """-> (int8 payloads, float32 scales, new error feedback), each a tree
    like ``grads``."""
    flat_g = flatten_with_paths(grads)
    flat_e = flatten_with_paths(error_fb)
    out = {k: _compress_one(g, flat_e[k]) for k, g in flat_g.items()}
    return tuple(unflatten_like(grads, {k: o[i] for k, o in out.items()})
                 for i in range(3))


def decompress(q_tree: Any, scale_tree: Any) -> Any:
    flat_s = flatten_with_paths(scale_tree)
    flat_q = flatten_with_paths(q_tree)
    return unflatten_like(q_tree, {k: q.float() * flat_s[k]
                                   for k, q in flat_q.items()})


def compressed_psum(grads: Any, error_fb: Any,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Tuple[Any, Any]:
    """All-reduce the int8 payloads over ``group`` (every rank calls it),
    summed in int32 so they cannot overflow, then averaged after
    decompression with this rank's scale, as the reference's psum over a
    mesh axis does -> (synced grads, new error feedback)."""
    q, s, new_e = compress(grads, error_fb)
    n = dist.get_world_size(group)
    flat_s = flatten_with_paths(s)
    synced = {k: all_reduce_sum(qq.to(torch.int32), group).float()
              * flat_s[k] / n
              for k, qq in flatten_with_paths(q).items()}
    return unflatten_like(grads, synced), new_e


def compression_ratio(grads: Any) -> float:
    """Payload ratio int8 + scale against float32 (a reporting helper)."""
    leaves = flatten_with_paths(grads).values()
    total_f32 = sum(g.numel() * 4 for g in leaves)
    total_q = sum(g.numel() * 1 + 4 for g in leaves)
    return total_q / total_f32
