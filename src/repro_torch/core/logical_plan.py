"""Logical plan operators (paper §IV-B Table III + §V).

Plans are immutable trees.  Each operator knows:
  * ``vars``      -- which query variables its output rows bind,
  * ``applied``   -- which predicates have been folded in already.
The optimizer (Algorithm 1) composes leaf plans bottom-up.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, FrozenSet, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PlanOp:
    def children(self) -> Tuple["PlanOp", ...]:
        return ()

    @property
    def vars(self) -> FrozenSet[str]:
        raise NotImplementedError

    @property
    def applied(self) -> FrozenSet[int]:
        out: FrozenSet[int] = frozenset()
        for c in self.children():
            out |= c.applied
        return out

    def describe(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = f"{pad}{type(self).__name__}{self._describe_args()}"
        lines = [head]
        for c in self.children():
            lines.append(c.describe(indent + 1))
        return "\n".join(lines)

    def _describe_args(self) -> str:
        return ""


@dataclasses.dataclass(frozen=True)
class AllNodeScan(PlanOp):
    var: str

    @property
    def vars(self) -> FrozenSet[str]:
        return frozenset({self.var})

    def _describe_args(self) -> str:
        return f"({self.var})"


@dataclasses.dataclass(frozen=True)
class NodeByLabelScan(PlanOp):
    var: str
    label: str

    @property
    def vars(self) -> FrozenSet[str]:
        return frozenset({self.var})

    def _describe_args(self) -> str:
        return f"({self.var}:{self.label})"


@dataclasses.dataclass(frozen=True)
class Filter(PlanOp):
    """Structured property filter (pushed to the column store / ES role)."""
    child: PlanOp
    predicate: Any          # cypherplus expression
    pred_id: int

    def children(self):
        return (self.child,)

    @property
    def vars(self):
        return self.child.vars

    @property
    def applied(self):
        return self.child.applied | {self.pred_id}

    def _describe_args(self):
        return f"[pred#{self.pred_id}]"


@dataclasses.dataclass(frozen=True)
class SemanticFilter(PlanOp):
    """Unstructured filter: needs sub-property extraction (AI model / cache /
    vector index).  The expensive one the optimizer pushes LATE.

    ``accuracy`` < 1.0 permits the executor to route the predicate through a
    calibrated proxy cascade (WITH ACCURACY clause); None means exact-only.
    It is part of the frozen plan identity, so plans cached for one target
    can never serve another.
    """
    child: PlanOp
    predicate: Any
    pred_id: int
    accuracy: Optional[float] = None

    def children(self):
        return (self.child,)

    @property
    def vars(self):
        return self.child.vars

    @property
    def applied(self):
        return self.child.applied | {self.pred_id}

    def _describe_args(self):
        if self.accuracy is not None and self.accuracy < 1.0:
            return f"[pred#{self.pred_id} acc>={self.accuracy}]"
        return f"[pred#{self.pred_id}]"


@dataclasses.dataclass(frozen=True)
class Expand(PlanOp):
    """ξ: follow relationships from bound src var to (new) dst var."""
    child: PlanOp
    src: str
    dst: str
    rel_type: Optional[str]
    direction: str          # out | in | any

    def children(self):
        return (self.child,)

    @property
    def vars(self):
        return self.child.vars | {self.dst}

    def _describe_args(self):
        arrow = {"out": "->", "in": "<-", "any": "--"}[self.direction]
        return f"({self.src}){arrow}({self.dst})"


@dataclasses.dataclass(frozen=True)
class Join(PlanOp):
    left: PlanOp
    right: PlanOp

    def children(self):
        return (self.left, self.right)

    @property
    def vars(self):
        return self.left.vars | self.right.vars

    def _describe_args(self):
        shared = sorted(self.left.vars & self.right.vars)
        return f"[on {','.join(shared) or 'x'}]"


@dataclasses.dataclass(frozen=True)
class Projection(PlanOp):
    child: PlanOp
    items: Tuple[Any, ...]

    def children(self):
        return (self.child,)

    @property
    def vars(self):
        return self.child.vars


@dataclasses.dataclass(frozen=True)
class Limit(PlanOp):
    child: PlanOp
    n: int

    def children(self):
        return (self.child,)

    @property
    def vars(self):
        return self.child.vars


# Table III operators surfaced as expression-level physical ops:
#   createFromSource -> FuncCall("createFromSource", ...) (executor)
#   extract()        -> SubProp evaluation via AIPM/cache (executor)
#   compareAsSet()   -> similarity ops ::, ~:, ... (executor)


def plan_ops(plan: PlanOp):
    yield plan
    for c in plan.children():
        yield from plan_ops(c)


def semantic_depth(plan: PlanOp, pred_id: int, depth: int = 0) -> int:
    """Distance of a predicate's filter from the root (for tests: late == small)."""
    if isinstance(plan, (Filter, SemanticFilter)) and plan.pred_id == pred_id:
        return depth
    for c in plan.children():
        d = semantic_depth(c, pred_id, depth + 1)
        if d >= 0:
            return d
    return -1
