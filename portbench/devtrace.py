"""The window under ``torch.profiler``, reduced in memory to what the
per-layer metrics and the breakdown read (no trace file is written).

``summarize`` returns:

* ``kernels``: [(name, calls, device seconds)] of every device operation
  (kernels, copies, sets) in the profile;
* ``busy_s``: the seconds of the window in which a device operation ran
  (the union of their intervals) and ``window_s``, the window's length on
  the profiler's clock;
* ``idle_gaps``: [(name, seconds)], the window's idle time on the device
  by the innermost host operation running at each gap's middle (a
  ``record_function`` label where no operator runs).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profiler over the block when ``enabled`` (its handle, else None)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(prof) -> Optional[Dict]:
    """The reduction above, or None when the profile holds no window."""
    from torch.autograd import DeviceType
    events = prof.events()
    win = [e for e in events
           if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if t < w0 or s > w1:
            continue
        if e.device_type == DeviceType.CUDA:
            if not _annotation(e):
                dev.append((max(s, w0), min(t, w1)))
        elif e.device_type == DeviceType.CPU and e.name != WINDOW:
            host.append((s, t, e.name))
    busy = _merge(dev)
    gaps, last = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    kernels = [(ev.key, int(ev.count), ev.self_device_time_total / 1e6)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.count
               and not _annotation(ev)]
    return {"kernels": kernels,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "idle_gaps": _name_gaps(gaps, host)}


def _annotation(e) -> bool:
    """A ``record_function`` label's copy on the device's timeline."""
    return bool(getattr(e, "is_user_annotation", False)) \
        or e.key.startswith("portbench.")


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host operation at each gap's middle.
    Host operations of one thread nest, so the ones running at a moment
    form a stack."""
    host.sort(key=lambda h: (h[0], -h[1]))
    total: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host operation)"
        total[name] += (g1 - g0) / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])


def per_call(kernels, calls: int, names=None) -> float:
    """Device seconds a call of ``calls``, each kernel at its mean time
    times its launches a call (rounded), so that a record the profiler
    drops does not read as a faster call; only kernels whose name holds
    one of ``names`` when given."""
    total = 0.0
    for name, count, secs in kernels:
        if names is not None and not any(n in name for n in names):
            continue
        launches = round(count / calls) or count / calls
        total += secs / count * launches
    return total
