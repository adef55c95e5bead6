"""Operation count of one call of a step, for one device: FLOPs, bytes
and collectives.

The counterpart of the reference's ``launch/hlo_analysis.py``.  Eager
PyTorch has no compiled module to walk, so this module counts the
operations that one call of the step actually runs, on whatever device its
arguments lie: on ``meta`` tensors nothing is computed or allocated, and a
full-size step is counted on any host.

**One device.**  Where the step runs on ``DTensor``s (the dry run on a
production mesh, ``launch/dryrun.py``), everything is counted for the rank
this process is, rank 0: the counting mode sits beneath DTensor's
dispatch.  A ``TorchDispatchMode`` is asked before a tensor subclass; for
an operation on DTensors it declines (returns ``NotImplemented``), DTensor
then runs the operation on its local shards and its collectives on the
process group, and each of those calls reaches the mode with plain local
tensors.  So the FLOPs and bytes are the local shards' and the collectives
are the ones DTensor (or a kernel wrapper's explicit redistribution)
inserts, each at its local result.  DTensor's sharding propagation runs
operations on ``FakeTensor``s of the global shapes: those are not counted.
On plain tensors (mesh ``one``) the same mode counts the whole step.

* **FLOPs**: each operation that ``torch.utils.flop_counter``'s registry
  knows (matmuls, batched matmuls, convolutions and their gradients;
  elementwise work is not counted, as the reference counts only ``dot``
  and ``convolution``), by the registry's formula at the local shapes.
* **Bytes**: each aten operation's operand and result bytes, XLA's "bytes
  accessed" convention.  As ``hlo_analysis.py`` does, it skips operations
  that move no data (views, ``empty*``, ``detach``: its
  ``_SKIP_BYTES_OPS``), counts a gather at twice its result and a scatter
  at three times its update.
* **Collectives**: each functional collective (``_c10d_functional``) by
  kind, under the reference's opcode names (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``), with its count and
  its bytes, the bytes of its local result (the reference's convention);
  ``top_collectives`` ranks them by kind and result shape.  On one rank
  there are none.
* **Hand kernels**: they run through ``ctypes`` (``kernels/build.py``),
  where no torch mode sees them, so each wrapper records the work of the
  function its kernel computes (its ``work``) as one entry under the
  kernel's name, on the card and on meta (on the CPU the plain version's
  aten operations are counted instead).  Under DTensor a wrapper runs on
  the local shards, so its work is the local shard's.
* **Repeats**: :func:`repeat` scales what a block counts, collectives
  included, by a trip count, as ``hlo_analysis.py`` scales a ``while``
  body: a loop over identical chunks runs one chunk on meta and counts it
  ``n`` times.
* **Peak bytes**: the most bytes of tensors alive at once during the call
  on this device (the arguments' local shards and every local result an
  operation allocates, until it is freed), the counterpart of XLA's memory
  analysis; the hand kernels' scratch is not seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

aten = torch.ops.aten

#: operations that move no data
_SKIP_BYTES_OPS = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.lift_fresh, aten.alias,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
}
#: gathers: twice their result (read the rows taken, write them)
_GATHER_OPS = {aten.embedding, aten.index_select, aten.gather, aten.index,
               aten.take_along_dim}
#: scatters: three times their update (read it, read and write the rows
#: it lands on); the update's position among the arguments
_SCATTER_OPS = {aten.index_add: 3, aten.index_add_: 3,
                aten.scatter_add: 3, aten.scatter_add_: 3,
                aten.scatter: 3, aten.scatter_: 3,
                aten.scatter_reduce: 3, aten.scatter_reduce_: 3,
                aten.index_copy: 3, aten.index_copy_: 3,
                aten.index_put: 2, aten.index_put_: 2,
                aten._index_put_impl_: 2}
#: functional collectives -> the reference's opcode names; the others of
#: their namespace (``wait_tensor``, autograd wrappers) move nothing
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast", "broadcast_": "broadcast",
                "shard_dim_alltoall": "all-to-all"}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor itself."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _storage_bytes(x: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``x`` (a model's
    parameters included; a DTensor's local shard)."""
    leaves, _ = tree_flatten(x)
    seen: Dict[int, int] = {}
    for t in leaves:
        ts = (t.parameters() if isinstance(t, torch.nn.Module)
              else [t] if isinstance(t, torch.Tensor) else [])
        for u in ts:
            st = _local(u).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _nbytes(x: Any) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or lists, tuples and dicts
    of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


@dataclasses.dataclass
class Analysis:
    """What one call counted.  ``kernels``: each hand kernel's calls, FLOPs
    and bytes; ``repeats``: the trip counts :func:`repeat` applied."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    repeats: List[int] = dataclasses.field(default_factory=list)
    peak_bytes: float = 0.0
    seconds: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_by_shape: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def top_collectives(self, n: int = 12) -> List[Tuple[str, float]]:
        """The largest collectives by bytes, keyed by kind and local
        result (the reference's ``top_collectives``)."""
        return sorted(self.coll_by_shape.items(), key=lambda kv: -kv[1])[:n]

    def top_flops(self, n: int = 12) -> List[Tuple[str, float]]:
        return sorted(self.flops_by_op.items(), key=lambda kv: -kv[1])[:n]

    def top_bytes(self, n: int = 12) -> List[Tuple[str, float]]:
        return sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]

    def as_dict(self) -> Dict[str, Any]:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": self.collective_bytes,
                "collectives": self.collectives, "kernels": self.kernels,
                "repeats": self.repeats, "peak_bytes": self.peak_bytes,
                "seconds": self.seconds,
                "top_flops": self.top_flops(),
                "top_bytes": self.top_bytes(),
                "top_collectives": self.top_collectives()}

    def _add(self, table: Dict[str, float], key: str, v: float) -> None:
        table[key] = table.get(key, 0.0) + v


def _is_fake(out: Any) -> bool:
    """An operation's result is a ``FakeTensor`` (DTensor's sharding
    propagation runs operations on them)."""
    if isinstance(out, (list, tuple)):
        return any(isinstance(t, FakeTensor) for t in out)
    return isinstance(out, FakeTensor)


class _Counter(TorchDispatchMode):
    """FLOPs, bytes and collectives of every aten operation on plain (or
    local) tensors, times the current repeat factor; the hand kernels'
    work through ``build.work_sinks``.  Operations on DTensors are left to
    DTensor, whose local operations come back here."""

    def __init__(self, an: Analysis, live: int = 0) -> None:
        super().__init__()
        self.an = an
        self.scale = 1.0
        self.live = live
        an.peak_bytes = float(live)

    def _allocated(self, func, out: Any) -> None:
        """Track the results ``func`` allocated (those that alias no
        input) until they are freed."""
        results = out if isinstance(out, (tuple, list)) else (out,)
        for r, ret in zip(results, func._schema.returns):
            if isinstance(r, torch.Tensor) and ret.alias_info is None:
                n = r.untyped_storage().nbytes()
                self.live += n
                weakref.finalize(r, self._freed, n)
        self.an.peak_bytes = max(self.an.peak_bytes, float(self.live))

    def _freed(self, n: int) -> None:
        self.live -= n

    def kernel(self, name: str, flops: float, n_bytes: float) -> None:
        an, s = self.an, self.scale
        k = an.kernels.setdefault(name, {"calls": 0.0, "flops": 0.0,
                                         "bytes": 0.0})
        k["calls"] += s
        k["flops"] += s * flops
        k["bytes"] += s * n_bytes
        an.flops += s * flops
        an.bytes_accessed += s * n_bytes
        an._add(an.flops_by_op, f"kernel {name}", s * flops)
        an._add(an.bytes_by_op, f"kernel {name}", s * n_bytes)

    def _collective(self, kind: str, out: Any) -> None:
        an, s = self.an, self.scale
        b = s * _nbytes(out)
        ent = an.collectives.setdefault(kind, {"count": 0.0, "bytes": 0.0})
        ent["count"] += s
        ent["bytes"] += b
        an.collective_bytes += b
        r = tree_flatten(out)[0][0]
        dtype = str(r.dtype).replace("torch.", "")
        an._add(an.coll_by_shape, f"{kind} {dtype}{list(r.shape)}", b)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_fake(out):
            return out
        self._allocated(func, out)
        packet = func.overloadpacket
        if packet in _SKIP_BYTES_OPS or func.is_view:
            return out
        if func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                self._collective(kind, out)
            return out
        an, s = self.an, self.scale
        if packet in flop_registry:
            f = s * flop_registry[packet](*args, **kwargs, out_val=out)
            if f:
                an.flops += f
                an._add(an.flops_by_op, str(packet), f)
        if packet in _GATHER_OPS:
            b = 2 * _nbytes(out)
        elif packet in _SCATTER_OPS:
            b = 3 * _nbytes(args[_SCATTER_OPS[packet]])
        else:
            b = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if b:
            an.bytes_accessed += s * b
            an._add(an.bytes_by_op, str(packet), s * b)
        return out


#: the counts running now (innermost last)
_active: List[_Counter] = []


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """Count what the block runs ``n`` times (a loop of ``n`` identical
    iterations that runs one of them), its collectives included.  Outside
    an analysis it does nothing."""
    if not _active or n == 1:
        yield
        return
    counter = _active[-1]
    counter.scale *= n
    try:
        yield
    finally:
        counter.scale /= n
        counter.an.repeats.append(n)


def analyze(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Analysis:
    """Run ``fn(*args, **kwargs)`` once and count its operations for this
    device (the module docstring says what is counted).  On ``meta``
    arguments nothing is computed; on the card the step runs as it always
    does, its hand kernels included."""
    an = Analysis()
    counter = _Counter(an, live=_storage_bytes((args, kwargs)))
    t0 = time.perf_counter()
    build.work_sinks.append(counter.kernel)
    _active.append(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _active.pop()
        build.work_sinks.remove(counter.kernel)
    an.seconds = time.perf_counter() - t0
    return an


def roofline(an: Analysis, peak_flops: float) -> Dict[str, Any]:
    """``compute_s`` (FLOPs at ``peak_flops``), ``memory_s`` (bytes at the
    card's memory rate), ``collective_s`` (collective bytes at the link
    rate, ``HW["link_bw"]``) and the largest of the three (``dominant``)."""
    from repro_torch.launch.mesh import HW

    terms = {"compute_s": an.flops / peak_flops,
             "memory_s": an.bytes_accessed / HW["hbm_bw"],
             "collective_s": an.collective_bytes / HW["link_bw"]}
    dominant = max(terms, key=terms.get)[:-2]
    return dict(terms, dominant=dominant)
