"""Nested parameter trees of the training modules: dicts (keys in sorted
order, as JAX flattens them), lists and tuples, with tensors or arrays as
leaves; None is an empty subtree.  Paths join the keys and indices with
"/", as the reference's checkpoint names its leaves."""
from __future__ import annotations

from typing import Any, Callable, Dict


def flatten_with_paths(tree: Any, prefix: str = "",
                       leaf_lists: bool = False) -> Dict[str, Any]:
    """{"/"-joined path: leaf} in the order JAX flattens the same tree;
    with ``leaf_lists`` a list is a leaf (a placement list of
    ``distributed.sharding.tree_shardings``)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) or (isinstance(tree, list)
                                     and not leaf_lists):
        items = ((str(i), x) for i, x in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten_with_paths(sub, f"{prefix}/{key}" if prefix
                                      else key, leaf_lists))
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to each leaf, its structure kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def unflatten_like(like: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    """``like``'s structure with each leaf taken from ``flat`` by path."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: unflatten_like(v, flat, f"{prefix}/{k}" if prefix
                                  else str(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten_like(x, flat, f"{prefix}/{i}" if prefix
                                         else str(i))
                          for i, x in enumerate(like))
    return flat[prefix]
