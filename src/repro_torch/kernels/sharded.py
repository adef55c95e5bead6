"""The hand kernels on ``DTensor``s: each wrapper runs its kernel on this
rank's shards.

A kernel runs through ``ctypes`` (``kernels/build.py``), so DTensor cannot
propagate through it.  A wrapper that is given DTensors places them where
its kernel can work on the local shards alone, takes the local tensors
(``to_local``), calls itself on them -- the kernel on the card, the work
record on meta, the plain version on the CPU -- and wraps the results
(``from_local``) with the placements its arithmetic gives them.

A wrapper never gathers an input silently: where a placement cannot be
served locally (a sequence or a feature dimension sharded, a ``Partial``
sum), the input is redistributed explicitly, with ``DTensor.redistribute``,
and an operation count (``launch/op_analysis.py``) sees that collective.
On a mesh of one rank every placement is local, and a wrapper computes
exactly what it computes on plain tensors.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)


def all_gather(t: torch.Tensor, dim: int, mesh, mesh_dim: int
               ) -> torch.Tensor:
    """A local tensor all-gathered along ``dim`` over one mesh dim (a
    functional collective: an operation count sees it)."""
    from torch.distributed import _functional_collectives as funcol
    fn = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor
    return fn(t, dim, (mesh, mesh_dim))


def reduce_scatter(t: torch.Tensor, dim: int, mesh, mesh_dim: int
                   ) -> torch.Tensor:
    """A local tensor's sum over one mesh dim, scattered along ``dim``."""
    from torch.distributed import _functional_collectives as funcol
    fn = getattr(funcol, "reduce_scatter_single", None) \
        or funcol.reduce_scatter_tensor
    return fn(t, "sum", dim, (mesh, mesh_dim))


def is_dtensor(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def mesh_names(t: DTensor) -> Tuple[str, ...]:
    """The names of ``t``'s mesh dims."""
    return tuple(t.device_mesh.mesh_dim_names or ())


def offset(t: DTensor, dim: int) -> int:
    """The global index of this rank's first row of ``t``'s dim ``dim``."""
    _, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                   t.placements)
    return off[dim] if off else 0


def sharded_over(t: DTensor, dim: int) -> List[int]:
    """The mesh dims that shard ``t``'s dim ``dim`` over more than one
    rank."""
    mesh = t.device_mesh
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1]


def keep_only(t: DTensor, dims: Iterable[int]) -> DTensor:
    """``t`` with only the tensor dims ``dims`` left sharded: any other
    ``Shard`` or a ``Partial`` becomes ``Replicate`` through an explicit
    redistribution (its collective is counted)."""
    dims = set(dims)
    want = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in t.placements]
    return to(t, want)


def to(t: DTensor, placements: Sequence) -> DTensor:
    """``t`` redistributed to ``placements`` (itself where it has them)."""
    if tuple(placements) == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(placements))


def follow(t: DTensor, like: DTensor, dim_map: dict) -> DTensor:
    """``t`` placed as ``like`` is, ``like``'s dim d mapped to ``t``'s
    ``dim_map[d]`` (``Replicate`` where ``like``'s sharded dim has no
    counterpart)."""
    want = [Shard(dim_map[p.dim]) if isinstance(p, Shard)
            and p.dim in dim_map else Replicate() for p in like.placements]
    return to(t, want)


def wrap(local: torch.Tensor, like: DTensor, placements: Sequence,
         shape: Tuple[int, ...]) -> DTensor:
    """A local result (made contiguous) as a DTensor of global ``shape``
    on ``like``'s mesh (made without a collective)."""
    local = local.contiguous()
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= max(size, 1)
    return DTensor.from_local(local, like.device_mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def mapped(placements: Sequence, dim_map: dict) -> List:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dim_map[d])``
    (``Replicate`` where d has no counterpart); a ``Partial`` stays."""
    out = []
    for p in placements:
        if isinstance(p, Shard):
            out.append(Shard(dim_map[p.dim]) if p.dim in dim_map
                       else Replicate())
        else:
            out.append(p)
    return out


def partial_where(placements: Sequence, mesh_dims: Iterable[int]) -> List:
    """``placements`` with ``Partial()`` (a sum) on ``mesh_dims``."""
    out = list(placements)
    for i in mesh_dims:
        out[i] = Partial()
    return out


def attention_inputs(q: DTensor, k: DTensor, v: DTensor,
                     kv_seq: bool = False
                     ) -> Tuple[DTensor, DTensor, DTensor]:
    """q [B, Sq, H, D], k and v [B, Skv, KVH, D(v)] placed for attention on
    the local shards: the batch (dim 0) and the heads (dim 2) may stay
    sharded and every other dim becomes whole, but for k's and v's
    sequence (dim 1) under ``kv_seq``, on a mesh dim where q is whole (the
    caller combines the ranks' partial softmaxes over it).  k and v follow
    q's batch sharding, and where q's heads are whole so are theirs.  Where
    q's heads are sharded and k's are not, each rank reads its query
    heads' key heads from its whole copy (:func:`kv_heads_of`)."""
    q = keep_only(q, (0, 2))
    kv_keep = (0, 1, 2) if kv_seq else (0, 2)
    k, v = keep_only(k, kv_keep), keep_only(v, kv_keep)
    want = []
    for pq, pk in zip(q.placements, k.placements):
        if isinstance(pq, Shard) and pq.dim == 0:
            want.append(Shard(0))
        elif isinstance(pq, Shard):
            want.append(pk if isinstance(pk, Shard) and pk.dim == 2
                        else Replicate())
        else:
            want.append(pk if kv_seq and isinstance(pk, Shard)
                        and pk.dim == 1 else Replicate())
    return q, to(k, want), to(v, want)


def kv_heads_of(q: DTensor, k: DTensor) -> slice:
    """The local key heads that this rank's query heads read: query head h
    reads key head h // (H / KVH) of the whole tensors."""
    h, kvh = q.shape[2], k.shape[2]
    g = h // kvh
    oq, ok = offset(q, 2), offset(k, 2)
    hl = q.to_local().shape[2]
    first, last = oq // g, (oq + hl - 1) // g
    kl = k.to_local().shape[2]
    a, b = first - ok, last - ok + 1
    if a < 0 or b > kl or (hl % (b - a)) != 0:
        raise ValueError(
            f"attention on shards: query heads {oq}..{oq + hl - 1} of {h} "
            f"read key heads {first}..{last} of {kvh}, which this rank's "
            f"{kl} key heads from {ok} do not hold evenly")
    return slice(a, b)


def kv_grad_placements(q: DTensor, k: DTensor) -> List:
    """The placements of k's gradient: k's own, and a ``Partial`` sum on
    every mesh dim that shards q's heads but not k's (each rank's query
    heads add to the key heads they read)."""
    out = list(k.placements)
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if isinstance(pq, Shard) and pq.dim == 2 and not (
                isinstance(pk, Shard) and pk.dim == 2):
            out[i] = Partial()
    return out


def unshard(t: DTensor, mesh_dims: Iterable[int]) -> DTensor:
    """``t`` gathered whole along each of ``mesh_dims`` (an FSDP weight's
    all-gather before its product), each dim it shards gathered from this
    rank's local shard alone -- one all-gather a mesh dim, whatever the
    other mesh dims shard -- and its gradient reduce-scattered back (or
    cut locally, where it arrives whole).  A dim that does not split
    evenly goes through ``DTensor.redistribute`` instead."""
    mesh = t.device_mesh
    dims = [i for i in mesh_dims if isinstance(t.placements[i], Shard)
            and mesh.size(i) > 1]
    if not dims:
        return t
    uneven = [i for i in dims
              if t.shape[t.placements[i].dim] % _shards_of(t, i)]
    if uneven:
        want = list(t.placements)
        for i in dims:
            want[i] = Replicate()
        return t.redistribute(mesh, tuple(want))
    return _Unshard.apply(t, tuple(dims))


def _shards_of(t: DTensor, mesh_dim: int) -> int:
    """The ranks that share ``t``'s dim sharded on ``mesh_dim``: the
    product of the sizes of every mesh dim that shards that tensor dim."""
    d = t.placements[mesh_dim].dim
    n = 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == d:
            n *= t.device_mesh.size(i)
    return n


class _Unshard(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, dims):
        mesh = t.device_mesh
        ctx.placements, ctx.dims = tuple(t.placements), dims
        local = t.to_local()
        want = list(t.placements)
        for i in dims:
            local = all_gather(local, want[i].dim, mesh, i)
            want[i] = Replicate()
        ctx.gathered = tuple(want)
        return DTensor.from_local(local, mesh, ctx.gathered,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    @staticmethod
    def backward(ctx, g):
        mesh = g.device_mesh
        if not isinstance(g, DTensor):
            raise TypeError("unshard: a plain gradient for a DTensor")
        # the gradient on the gathered placements, partial sums kept
        want = [p if isinstance(p, Partial) and i in ctx.dims else q
                for i, (p, q) in enumerate(zip(g.placements, ctx.gathered))]
        g = to(g, want)
        local = g.to_local()
        for i in reversed(ctx.dims):
            d = ctx.placements[i].dim
            if isinstance(want[i], Partial):
                local = reduce_scatter(local, d, mesh, i)
            else:
                k = mesh.size(i)
                local = local.chunk(k, dim=d)[
                    mesh.get_local_rank(i)].contiguous()
        return DTensor.from_local(local, mesh, ctx.placements,
                                  run_check=False, shape=g.shape,
                                  stride=g.stride()), None
