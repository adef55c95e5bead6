"""Training driver: step, checkpointing, restart -- the reference's
``training/train_loop.py`` run eagerly.

``params`` is a tree (nested dicts) of tensors that require gradients --
an LM's own parameters (``models.transformer.params_to_jax_tree``) or any
other -- and ``loss_fn(params, batch)`` returns a scalar loss tensor.
Each step takes the gradient with ``torch.autograd.grad`` and applies
``adamw_update``, which writes the parameters in place.  A checkpoint holds
(params, opt_state) under the reference's keys; on restart the loop
restores the latest one into the parameters and resumes at its version.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            gradients, init_opt_state)
from repro_torch.training.tree import flatten_with_paths, tree_map


@dataclasses.dataclass
class TrainLoopConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    restore: bool = True


def run_train_loop(loss_fn: Callable, params: Any, batches: Iterator[Dict],
                   cfg: TrainLoopConfig,
                   opt_cfg: Optional[AdamWConfig] = None,
                   meta: Optional[Dict] = None) -> Dict[str, Any]:
    """Train ``params`` in place from step 0 (or the latest checkpoint's
    version) to ``cfg.n_steps``; each batch (a dict of arrays) moves to the
    parameters' device.  -> {"params", "opt_state", "history", "wall_s",
    "final_loss"}."""
    opt_cfg = opt_cfg or AdamWConfig()
    flat = flatten_with_paths(params)
    device = next(iter(flat.values())).device
    opt_state = init_opt_state(flat)
    start_step = 0
    ckpt = CheckpointManager(cfg.ckpt_dir) if cfg.ckpt_dir else None
    if ckpt and cfg.restore and ckpt.latest_version() is not None:
        (p_saved, o_saved), start_step = ckpt.restore((params, opt_state))
        with torch.no_grad():
            for key, t in flatten_with_paths(p_saved).items():
                flat[key].copy_(t)
        opt_state = o_saved
        print(f"[train] restored version {start_step}")

    history = []
    t_start = time.perf_counter()
    it = iter(batches)
    for i in range(start_step, cfg.n_steps):
        batch = tree_map(lambda a: torch.as_tensor(a, device=device),
                         next(it))
        loss = loss_fn(params, batch)
        _, opt_state, om = adamw_update(gradients(loss, flat), opt_state,
                                        flat, opt_cfg)
        if i % cfg.log_every == 0 or i == cfg.n_steps - 1:
            l, gn = float(loss.detach()), float(om["grad_norm"])
            history.append({"step": i, "loss": l, "grad_norm": gn})
            print(f"[train] step {i} loss {l:.4f} gnorm {gn:.3f}")
        if ckpt and ((i + 1) % cfg.ckpt_every == 0 or i == cfg.n_steps - 1):
            ckpt.save(i + 1, (params, opt_state), meta=meta)
    wall = time.perf_counter() - t_start
    return {"params": params, "opt_state": opt_state, "history": history,
            "wall_s": wall,
            "final_loss": history[-1]["loss"] if history else None}
