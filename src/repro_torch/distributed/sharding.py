"""Logical-axis sharding rules (t5x-style) mapping model axes -> mesh axes.

The reference's ``distributed/sharding.py`` without JAX.  Model code names
each dimension of an array by a *logical* axis ("batch", "heads", "mlp",
...); a :class:`ShardingRules` table maps each logical name to zero or more
*physical* mesh axes.  ``spec`` gives the plain tuple that the reference's
``PartitionSpec`` holds; ``logical_sharding`` turns it into
``torch.distributed.tensor`` placements on a ``DeviceMesh``.

Physical axes:
  * ``pod``   -- DP across pods
  * ``data``  -- DP + FSDP + corpus/KV-sequence sharding within a pod
  * ``model`` -- TP (heads / mlp / vocab) and EP (experts)

``base_rules`` and ``decode_rules`` read only the mesh's axis names and
sizes: a ``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or any object with
``axis_names`` and a ``shape`` mapping, so rule tables for large meshes can
be built and checked without their devices.

``place`` and ``place_tree`` turn tensors into ``DTensor``s by their specs
with no collective: each becomes ``DTensor.from_local`` of this rank's
shard, an empty tensor of the shard's shape on the tensor's own device
(``meta`` in the dry run), with the global shape and stride.  An uneven
dimension is cut as ``torch.chunk`` cuts it: rank 0 holds the largest
shard.  ``place_module`` does the same for a module's parameters, in place.
With ``values`` (``distribute``) each rank keeps its chunk of the
tensor's values instead, still with no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

AxisVal = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisVal, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name -> physical mesh axis (or tuple, or None)."""

    rules: Dict[str, AxisVal]

    def spec(self, *logical_axes: Optional[str]) -> Spec:
        """The partition spec of an array whose dims carry these logical
        names: one entry a dim, trailing Nones dropped, no physical axis
        named twice (a later dim that would reuse one loses it)."""
        out: List[AxisVal] = []
        seen: List[str] = []
        for ax in logical_axes:
            phys = self.rules.get(ax) if ax is not None else None
            if phys is not None:
                flat = (phys,) if isinstance(phys, str) else tuple(phys)
                flat = tuple(a for a in flat if a not in seen)
                seen.extend(flat)
                phys = flat if len(flat) > 1 else (flat[0] if flat else None)
            out.append(phys)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def with_overrides(self, **kw: AxisVal) -> "ShardingRules":
        new = dict(self.rules)
        new.update(kw)
        return ShardingRules(new)


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of an object with
    ``axis_names`` and a ``shape`` mapping, in the mesh's axis order."""
    if hasattr(mesh, "mesh_dim_names"):          # a DeviceMesh
        return {n: mesh.size(i)
                for i, n in enumerate(mesh.mesh_dim_names or ())}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def base_rules(mesh: Any, *, fsdp: bool = False) -> ShardingRules:
    """Default rule table, adapted to whichever axes the mesh actually has."""
    axes = mesh_axes(mesh)
    has = lambda a: axes.get(a, 1) > 1  # noqa: E731
    batch_axes = tuple(a for a in ("pod", "data") if a in axes)
    data = "data" if has("data") else None
    model = "model" if has("model") else None
    wide = tuple(a for a in ("data", "model") if has(a)) or None
    rules: Dict[str, AxisVal] = {
        # --- activations ---
        "batch": batch_axes or None,
        "seq": None,
        "embed": None,             # activations keep d_model replicated
        "heads": model,
        "kv_heads": model,
        "head_dim": None,
        "mlp": model,
        "vocab": model,
        "expert": model,
        "kv_seq": None,            # overridden for decode shapes
        "qk_lora": None,
        # --- params ---
        "p_embed": data if fsdp else None,   # FSDP axis on weight matrices
        "p_vocab": model,
        "p_heads": model,
        "p_mlp": model,
        "p_expert": model,
        "p_kv_heads": model,
        "layers": None,
        # --- pandadb / gnn / recsys ---
        "corpus": wide,
        "edge": data,
        "node": None,
        "feat": None,
        "table_row": wide,
        "candidate": wide,
        "field": None,
    }
    return ShardingRules(rules)


def decode_rules(mesh: Any, *, shard_seq_over_data: bool = False,
                 fsdp: bool = False) -> ShardingRules:
    """Decode shapes: KV cache sequence-sharded.

    ``shard_seq_over_data=True`` (long_500k, batch=1): the batch axis cannot
    use ``data``, so the KV sequence takes both ``data`` and ``model``."""
    r = base_rules(mesh, fsdp=fsdp)
    axes = mesh_axes(mesh)
    has = lambda a: axes.get(a, 1) > 1  # noqa: E731
    if shard_seq_over_data:
        kv_seq = tuple(a for a in ("data", "model") if has(a)) or None
        batch = ("pod",) if has("pod") else None
        # attention heads cannot also be sharded over model: keep heads local
        return r.with_overrides(kv_seq=kv_seq, batch=batch, heads=None,
                                kv_heads=None)
    kv_seq = "model" if has("model") else None
    return r.with_overrides(kv_seq=kv_seq, heads=None, kv_heads=None)


LOGICAL_RULES = base_rules  # legacy alias


def logical_spec(rules: ShardingRules, *axes: Optional[str]) -> Spec:
    return rules.spec(*axes)


def logical_sharding(mesh: Any, rules: ShardingRules,
                     *axes: Optional[str]) -> List[Any]:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for an array whose
    dims carry these logical names (:func:`spec_placements` of their
    spec)."""
    return spec_placements(mesh, rules.spec(*axes))


def spec_placements(mesh: Any, spec: Spec) -> List[Any]:
    """DTensor placements on ``mesh`` for a partition spec: ``Shard(dim)``
    on each mesh dim the spec names for tensor dim ``dim``,
    ``Replicate()`` on the others."""
    shard_of: Dict[str, int] = {}
    for dim, phys in enumerate(spec):
        for a in (() if phys is None else (phys,) if isinstance(phys, str)
                  else phys):
            shard_of[a] = dim
    return [Shard(shard_of[n]) if n in shard_of else Replicate()
            for n in mesh_axes(mesh)]


def constrain(x: torch.Tensor, rules: Optional[ShardingRules],
              *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a ``DTensor`` to the placements of these logical names,
    and its gradient to the same placements in the backward (the
    reference's ``with_sharding_constraint``, whose transpose constrains
    the cotangent alike); a plain tensor (or no rules) is returned
    unchanged (the reference's no-op off-mesh)."""
    if rules is None or not isinstance(x, DTensor):
        return x
    placements = tuple(logical_sharding(x.device_mesh, rules, *axes))
    if not x.requires_grad:
        return x.redistribute(x.device_mesh, placements)
    return _Constrain.apply(x, placements)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, its gradient too."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def tree_shardings(mesh: Any, rules: ShardingRules, spec_tree: Any) -> Any:
    """Map a nested dict of logical-axis tuples (or None) to placements."""
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(mesh, rules, v)
                for k, v in spec_tree.items()}
    return logical_sharding(mesh, rules, *(spec_tree or ()))


def local_shape(shape: Tuple[int, ...], placements: List[Any],
                mesh: Any) -> Tuple[int, ...]:
    """The shape of the shard that the mesh's first rank (coordinate 0 on
    every mesh dim) holds of a tensor of ``shape`` under ``placements``:
    each ``Shard(d)``, in mesh-dim order, keeps the first ``torch.chunk``
    piece of dim d, ceil(n / k) of its n rows over k ranks."""
    out = list(shape)
    sizes = list(mesh_axes(mesh).values())
    for k, p in zip(sizes, placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // k)
    return tuple(out)


def place(t: torch.Tensor, mesh: Any, spec: Spec,
          device: Optional[torch.device] = None) -> DTensor:
    """``t`` as a ``DTensor`` on ``mesh`` (a ``DeviceMesh``) placed by the
    partition ``spec``, made without a collective: this rank's shard is a
    new empty tensor on ``device`` (default: ``t``'s; its values are not
    copied: the dry run's tensors are ``meta``), wrapped with ``t``'s global
    shape and stride."""
    return place_new(tuple(t.shape), t.dtype, mesh, spec,
                     device or t.device)


def place_new(shape: Tuple[int, ...], dtype: torch.dtype, mesh: Any,
              spec: Spec, device: Any) -> DTensor:
    """A new contiguous ``DTensor`` of global ``shape`` placed by ``spec``,
    its local shard empty on ``device`` (nothing of the global size is
    allocated)."""
    placements = spec_placements(mesh, spec)
    local = torch.empty(local_shape(shape, placements, mesh), dtype=dtype,
                        device=device)
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= max(size, 1)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def distribute(t: torch.Tensor, mesh: Any, spec: Spec) -> DTensor:
    """``t``'s values as a ``DTensor`` placed by ``spec``: each rank keeps
    its own chunk of ``t`` (which every rank holds whole), with no
    collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, spec_placements(mesh, spec),
                             src_data_rank=None)


def place_tree(arg: Any, spec: Any, mesh: Any, values: bool = False) -> Any:
    """:func:`place` over a tree of tensors (dicts, tuples, lists) and its
    tree of specs; with ``values`` each keeps its values
    (:func:`distribute`).  A module is placed in place
    (:func:`place_module`) and returned."""
    if isinstance(arg, torch.nn.Module):
        return place_module(arg, spec, mesh, values)
    if isinstance(arg, torch.Tensor):
        return distribute(arg, mesh, spec) if values else place(arg, mesh,
                                                                 spec)
    if isinstance(arg, dict):
        return {k: place_tree(v, spec[k], mesh, values)
                for k, v in arg.items()}
    return type(arg)(place_tree(v, s, mesh, values)
                     for v, s in zip(arg, spec))


def place_module(module: torch.nn.Module, specs: Dict[str, Spec],
                 mesh: Any, values: bool = False) -> torch.nn.Module:
    """Replace each parameter of ``module`` (keyed as ``named_parameters``
    names it in ``specs``) by a parameter holding its :func:`place` (its
    :func:`distribute` with ``values``)."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        t = p.detach()
        sub._parameters[leaf] = torch.nn.Parameter(
            distribute(t, mesh, specs[name]) if values
            else place(t, mesh, specs[name]), requires_grad=p.requires_grad)
    return module
