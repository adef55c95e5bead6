"""Distributed collective schedules over a ``torch.distributed`` group.

The reference's ``distributed/collectives.py``, whose functions run under
``shard_map``; here each is the per-rank body, called by every rank of the
process group (``group=None``: the default group).

``sharded_topk``: the vector-index / retrieval pattern -- local exact top-k
per shard, all-gather of the tiny (val, id) pairs, final merge.  One
collective of O(shards * k) instead of gathering O(corpus).

``all_reduce_sum``: one sum over the group, the reference's ``psum`` (the
compressed gradient all-reduce of ``training/compression.py`` sums its
int8 payloads in int32 through it).

``partial_softmax_combine``: the flash-decoding combine used when the KV
cache is sequence-sharded (long_500k): an all-reduce of the max, then one
of (max-shifted sum, accumulator).  It is the arithmetic of the
decode-attention kernel's combine of its key chunks
(``csrc/decode_attention.cu``), with ranks in place of chunks.

NCCL takes one rank per card, so a single card runs a world of one rank;
gloo runs more ranks on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.topk import stable_topk


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over every rank of the group, on every rank (a new
    tensor; ``x`` is left as it was)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def sharded_topk(q: torch.Tensor, corpus_local: torch.Tensor,
                 ids_local: torch.Tensor, k: int, metric: str = "l2",
                 group: Optional[dist.ProcessGroup] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [Q, d] (the same on every rank), this rank's corpus rows [N_r, d]
    and their ids [N_r] -> the global top-k (vals [Q, k] f32, ids [Q, k]),
    the same on every rank.  Every rank holds as many rows (as the
    reference's even shards do)."""
    from repro_torch.core.vector_index import merge_topk, pairwise_scores

    s = pairwise_scores(q, corpus_local, metric)
    v, i = stable_topk(s, min(k, corpus_local.shape[0]))
    vals = ids_local[i]
    # gather per-shard candidates ([n_shards, Q, k]) and reduce through
    # the ONE merge schedule every scatter-gather kNN shares
    world = dist.get_world_size(group)
    v_all = v.new_empty((world,) + tuple(v.shape))
    i_all = vals.new_empty((world,) + tuple(vals.shape))
    dist.all_gather_into_tensor(v_all.view(-1, v.shape[1]), v.contiguous(),
                                group=group)
    dist.all_gather_into_tensor(i_all.view(-1, vals.shape[1]),
                                vals.contiguous(), group=group)
    return merge_topk(v_all, i_all, k)


def partial_softmax_combine(scores_local: torch.Tensor,
                            values_local: torch.Tensor,
                            group: Optional[dist.ProcessGroup] = None
                            ) -> torch.Tensor:
    """scores [..., S_r], values [..., S_r, D]: this rank's part of the S
    axis -> softmax(scores) @ values over the whole axis, on every rank."""
    m = scores_local.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(scores_local - m)
    num = torch.einsum("...s,...sd->...d", p, values_local)
    # the accumulator and the sum of p in one all-reduce
    both = torch.cat([num, p.sum(dim=-1, keepdim=True)], dim=-1)
    dist.all_reduce(both, op=dist.ReduceOp.SUM, group=group)
    return both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-30)
