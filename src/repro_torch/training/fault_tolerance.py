"""Fault tolerance and elasticity, the reference's
``training/fault_tolerance.py``.

1. **Checkpoint/restart**: versioned manifests (checkpoint.py); on a
   failure the job restarts from ``latest_version``.
2. **Elastic re-mesh**: ``elastic_restart`` factors the surviving device
   count into a (data, model) ``DeviceMesh``, builds placements from the
   SAME logical axis rules (``distributed/sharding.py``) and places the
   restored state on it; no model code changes.
3. **Straggler mitigation**: ``StragglerMonitor`` tracks per-host step
   latencies; a host whose EWMA exceeds ``threshold`` x the median is
   flagged for the scheduler to drain.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.distributed.sharding import ShardingRules, tree_shardings
from repro_torch.training.checkpoint import CheckpointManager


def make_mesh_for(n_devices: int, model_parallel: int = 1,
                  device_type: str = "cuda"):
    """Elastic mesh: whatever devices survive, factored (data, model).  The
    default process group must hold ``n_devices`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    assert n_devices % model_parallel == 0
    return init_device_mesh(device_type,
                            (n_devices // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def elastic_restart(ckpt: CheckpointManager, like_state: Any,
                    rules_fn: Callable[[Any], ShardingRules], axes_tree: Any,
                    n_devices: int, model_parallel: int = 1,
                    device_type: str = "cuda"):
    """Restore the latest checkpoint onto a fresh mesh of ``n_devices`` ->
    (mesh, rules, state of DTensors, version).

    ``rules_fn(mesh)`` must be the rule builder used at launch;
    ``axes_tree`` is the logical-axis tree of the state."""
    mesh = make_mesh_for(n_devices, model_parallel, device_type)
    rules = rules_fn(mesh)
    placements = tree_shardings(mesh, rules, axes_tree)
    state, version = ckpt.restore(like_state, mesh=mesh,
                                  placements=placements)
    return mesh, rules, state, version


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    threshold: float = 1.5
    alpha: float = 0.3
    ewma: Optional[np.ndarray] = None

    def record(self, host_times: np.ndarray) -> List[int]:
        """Feed per-host step latencies; returns hosts flagged as
        stragglers."""
        host_times = np.asarray(host_times, np.float64)
        if self.ewma is None:
            self.ewma = host_times.copy()
        else:
            self.ewma = self.alpha * host_times + (1 - self.alpha) * self.ewma
        med = float(np.median(self.ewma))
        return [i for i, t in enumerate(self.ewma)
                if med > 0 and t > self.threshold * med]


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 100
    backoff_s: float = 5.0

    def run(self, step_fn: Callable[[], Any],
            on_failure: Callable[[Exception], None]) -> Any:
        """Supervision loop: run until success or the restart budget is
        spent."""
        for attempt in range(self.max_restarts):
            try:
                return step_fn()
            except Exception as e:  # noqa: BLE001
                on_failure(e)
                time.sleep(min(self.backoff_s * (attempt + 1), 60.0))
        raise RuntimeError(f"exceeded {self.max_restarts} restarts")
