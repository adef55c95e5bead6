"""Versioned checkpointing, the reference's ``training/checkpoint.py``
with its on-disk layout, so either package reads the other's checkpoints.

Every checkpoint carries a monotonically increasing ``version`` (the train
step).  A manifest records the version, the leaf keys and free metadata;
restore loads to the host and moves the leaves onto a device, or places
them on a ``DeviceMesh`` (the elastic path after a node failure).

Layout:
  <dir>/manifest.json            latest-version pointer + history
  <dir>/step_<v>/manifest.json   per-checkpoint metadata
  <dir>/step_<v>/arrays.npz      flattened leaves (host copy), keyed by
                                 their "/"-joined paths

bfloat16 leaves are stored as the reference stores them: numpy has no
bfloat16, and the reference's bfloat16 arrays land in the npz as raw
2-byte values ("|V2"), read back here as bfloat16 bit patterns.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import flatten_with_paths, unflatten_like


def to_numpy(x: Any) -> np.ndarray:
    """A leaf as the npz stores it (bfloat16 as raw 2-byte values)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def from_numpy(a: np.ndarray, like: Any, device=None) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype (a tensor's, else the
    array's own) on ``device`` (default: ``like``'s, else the CPU)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        device = like.device if device is None else device
        t = t.to(like.dtype)
    return t.to(device or "cpu")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save -------------------------------------------------------------------

    def save(self, version: int, state: Any,
             meta: Optional[Dict[str, Any]] = None) -> Path:
        step_dir = self.dir / f"step_{version}"
        tmp = self.dir / f".tmp_step_{version}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {k: to_numpy(v)
                  for k, v in flatten_with_paths(state).items()}
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "version": version,
            "time": time.time(),
            "keys": sorted(arrays.keys()),
            "meta": meta or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp.rename(step_dir)                       # atomic publish
        self._update_root(version)
        self._gc()
        return step_dir

    def _update_root(self, version: int) -> None:
        root = {"latest": version, "history": sorted(self.versions())}
        (self.dir / "manifest.json").write_text(json.dumps(root, indent=1))

    def _gc(self) -> None:
        vs = sorted(self.versions())
        for v in vs[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{v}", ignore_errors=True)
        if vs:
            self._update_root(vs[-1])

    # -- restore ----------------------------------------------------------------

    def versions(self) -> List[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_version(self) -> Optional[int]:
        vs = self.versions()
        return max(vs) if vs else None

    def restore(self, like: Any, version: Optional[int] = None,
                device=None, mesh=None, placements: Any = None
                ) -> Tuple[Any, int]:
        """Load into the structure of ``like`` (its leaves give each
        tensor's dtype and device; ``device`` overrides the device) ->
        (state, version).  Given a ``DeviceMesh`` and a tree of placements
        like ``like`` (``distributed.sharding.tree_shardings``), each leaf
        becomes a ``DTensor`` on the mesh: the elastic re-mesh restore."""
        version = version if version is not None else self.latest_version()
        if version is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        data = np.load(self.dir / f"step_{version}" / "arrays.npz")
        flat_like = flatten_with_paths(like)
        for key in flat_like:
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
        leaves = {k: from_numpy(data[k], lk, device)
                  for k, lk in flat_like.items()}
        if mesh is not None:
            from torch.distributed.tensor import distribute_tensor
            flat_pl = flatten_with_paths(placements, leaf_lists=True)
            leaves = {k: distribute_tensor(t, mesh, flat_pl[k])
                      for k, t in leaves.items()}
        return unflatten_like(like, leaves), version

    def meta(self, version: Optional[int] = None) -> Dict[str, Any]:
        version = version if version is not None else self.latest_version()
        return json.loads(
            (self.dir / f"step_{version}" / "manifest.json").read_text())
