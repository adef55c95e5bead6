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
    dims carry these logical names: ``Shard(dim)`` on each mesh dim the
    spec names for tensor dim ``dim``, ``Replicate()`` on the others."""
    shard_of: Dict[str, int] = {}
    for dim, phys in enumerate(rules.spec(*axes)):
        for a in (() if phys is None else (phys,) if isinstance(phys, str)
                  else phys):
            shard_of[a] = dim
    return [Shard(shard_of[n]) if n in shard_of else Replicate()
            for n in mesh_axes(mesh)]


def constrain(x: torch.Tensor, rules: ShardingRules,
              *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a ``DTensor`` to the placements of these logical names;
    a plain tensor is returned unchanged (the reference's no-op off-mesh)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          logical_sharding(x.device_mesh, rules, *axes))


def tree_shardings(mesh: Any, rules: ShardingRules, spec_tree: Any) -> Any:
    """Map a nested dict of logical-axis tuples (or None) to placements."""
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(mesh, rules, v)
                for k, v in spec_tree.items()}
    return logical_sharding(mesh, rules, *(spec_tree or ()))
