"""Operation count of one call of a step: FLOPs, bytes and collectives.

The counterpart of the reference's ``launch/hlo_analysis.py``.  Eager
PyTorch has no compiled module to walk, so this module counts the
operations that one call of the step actually runs, on whatever device its
arguments lie: on ``meta`` tensors nothing is computed or allocated, and a
full-size step is counted on any host.

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  matmuls, batched matmuls, convolutions; elementwise work is not
  counted, as the reference counts only ``dot`` and ``convolution``).
* **Bytes**: a ``TorchDispatchMode`` adds each aten operation's operand
  and result bytes, XLA's "bytes accessed" convention.  As
  ``hlo_analysis.py`` does, it skips operations that move no data (views,
  ``empty*``, ``detach``: its ``_SKIP_BYTES_OPS``), counts a gather at
  twice its result and a scatter at three times its update.
* **Collectives**: ``torch.distributed.tensor.debug.CommDebugMode``
  counts them, and the byte mode adds each functional collective's result
  bytes; on one rank there are none.
* **Hand kernels**: they run through ``ctypes`` (``kernels/build.py``),
  where no torch mode sees them, so each wrapper records the work of the
  function its kernel computes (its ``work``) as one entry under the
  kernel's name, on the card and on meta (on the CPU the plain version's
  aten operations are counted instead).
* **Repeats**: :func:`repeat` scales what a block counts by a trip count,
  as ``hlo_analysis.py`` scales a ``while`` body: a loop over identical
  chunks runs one chunk on meta and counts it ``n`` times.
* **Peak bytes**: the most bytes of tensors alive at once during the call
  (the arguments and every result an operation allocates, until it is
  freed), the counterpart of XLA's memory analysis; the hand kernels'
  scratch is not seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

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


def _storage_bytes(x: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``x`` (a model's
    parameters included)."""
    leaves, _ = tree_flatten(x)
    seen: Dict[int, int] = {}
    for t in leaves:
        ts = (t.parameters() if isinstance(t, torch.nn.Module)
              else [t] if isinstance(t, torch.Tensor) else [])
        for u in ts:
            st = u.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _nbytes(x: Any) -> int:
    leaves, _ = tree_flatten(x)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


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
                "top_bytes": self.top_bytes()}

    def _add(self, table: Dict[str, float], key: str, v: float) -> None:
        table[key] = table.get(key, 0.0) + v


class _Counter(TorchDispatchMode):
    """Bytes (and collective bytes) of every aten operation, times the
    current repeat factor; the hand kernels' work through
    ``build.work_sinks``."""

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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._allocated(func, out)
        packet = func.overloadpacket
        if packet in _SKIP_BYTES_OPS or func.is_view:
            return out
        if func.namespace in ("_c10d_functional", "c10d"):
            b = self.scale * _nbytes(out)
            ent = self.an.collectives.setdefault(
                packet.__name__, {"count": 0.0, "bytes": 0.0})
            ent["count"] += self.scale
            ent["bytes"] += b
            self.an.collective_bytes += b
            return out
        if packet in _GATHER_OPS:
            b = 2 * _nbytes(out)
        elif packet in _SCATTER_OPS:
            b = 3 * _nbytes(args[_SCATTER_OPS[packet]])
        else:
            b = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if b:
            self.an.bytes_accessed += self.scale * b
            self.an._add(self.an.bytes_by_op, str(packet),
                         self.scale * b)
        return out


#: the counts running now (innermost last)
_active: List[Tuple[_Counter, FlopCounterMode]] = []


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """Count what the block runs ``n`` times (a loop of ``n`` identical
    iterations that runs one of them).  Outside an analysis it does
    nothing."""
    if not _active or n == 1:
        yield
        return
    counter, flop_mode = _active[-1]
    before = dict(flop_mode.get_flop_counts().get("Global", {}))
    counter.scale *= n
    try:
        yield
    finally:
        counter.scale /= n
        counter.an.repeats.append(n)
        after = flop_mode.get_flop_counts().get("Global", {})
        for op, total in after.items():
            extra = (n - 1) * (total - before.get(op, 0))
            if extra:
                counter.an.flops += extra
                counter.an._add(counter.an.flops_by_op, str(op), extra)


def analyze(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Analysis:
    """Run ``fn(*args, **kwargs)`` once and count its operations (the
    module docstring says what is counted).  On ``meta`` arguments nothing
    is computed; on the card the step runs as it always does, its hand
    kernels included."""
    from torch.distributed.tensor.debug import CommDebugMode

    an = Analysis()
    counter = _Counter(an, live=_storage_bytes((args, kwargs)))
    flop_mode = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    build.work_sinks.append(counter.kernel)
    _active.append((counter, flop_mode))
    try:
        with CommDebugMode() as comm, flop_mode, counter, \
                warnings.catch_warnings():
            # the flop counter's module hooks warn on a module whose
            # inputs need no gradient (a GNN's features)
            warnings.filterwarnings("ignore", "Full backward hook")
            fn(*args, **kwargs)
    finally:
        _active.pop()
        build.work_sinks.remove(counter.kernel)
    for op, n in flop_mode.get_flop_counts().get("Global", {}).items():
        an._add(an.flops_by_op, str(op), float(n))
    an.flops += float(flop_mode.get_total_flops())
    for op, n in comm.get_comm_counts().items():
        ent = an.collectives.setdefault(getattr(op, "__name__", str(op)),
                                        {"count": 0.0, "bytes": 0.0})
        ent["count"] = max(ent["count"], float(n))
    an.seconds = time.perf_counter() - t0
    return an


def roofline(an: Analysis, peak_flops: float) -> Dict[str, Any]:
    """``compute_s`` (FLOPs at ``peak_flops``), ``memory_s`` (bytes at the
    card's memory rate) and which of the two is larger (``dominant``)."""
    from repro_torch.launch.mesh import HW

    compute_s = an.flops / peak_flops
    memory_s = an.bytes_accessed / HW["hbm_bw"]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory"}
