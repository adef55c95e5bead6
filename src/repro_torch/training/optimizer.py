"""AdamW over a dict of tensors, the reference's ``training/optimizer.py``.

The first and second moments are float32 tensors of the parameters'
shapes, with no float32 master copy: each update is computed in float32
and cast back to the parameter's dtype.  Gradients are clipped by their
global norm, and the learning rate warms up linearly.

The update writes the parameters and the moments in place (the reference
returns new arrays): at full width the moments alone are 8 bytes a
parameter, and a second copy of them would not fit one card.  ``step``
stays a 0-d int32 tensor, and the bias corrections ``b1 ** step`` are
float32 powers of a float32 step, as the reference's are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.training.tree import flatten_with_paths

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def gradients(loss: torch.Tensor, params: Tensors) -> Tensors:
    """d loss / d each of ``params`` -> {name: gradient}; zeros for a
    tensor the loss does not reach (as the reference's grad gives)."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), gs)}


def init_opt_state(params: Tensors) -> Dict[str, Any]:
    """{"m", "v": float32 zeros like each parameter, "step": int32 0}."""
    dev = next(iter(params.values())).device if params else None
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten_with_paths(tree).values()))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """cfg.lr * min(1, (step + 1) / warmup_steps), float32."""
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(grads: Tensors, opt_state: Dict[str, Any], params: Tensors,
                 cfg: AdamWConfig
                 ) -> Tuple[Tensors, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: params and the moments updated in place ->
    (params, opt_state with the step advanced, {"grad_norm", "lr"})."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    stepf = step.float()
    b1p = torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                 device=stepf.device), stepf)
    b2p = torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                 device=stepf.device), stepf)
    bc1, bc2 = 1 - b1p, 1 - b2p
    for name, p in params.items():
        g = grads[name].float() * scale.to(p.device)
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        pf = p.float()
        delta = (m / bc1.to(p.device)).div_(
            (v / bc2.to(p.device)).sqrt_().add_(cfg.eps))
        delta.add_(pf * cfg.weight_decay)
        p.copy_(pf.sub_(delta.mul_(lr.to(p.device))))
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}
