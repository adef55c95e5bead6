"""The LM's step functions: the reference's ``train_step``,
``prefill_step`` and ``serve_step`` (``launch/steps.py``) without meshes,
shardings or abstract shapes -- one card runs them eagerly, for every LM
config (dense, MoE, MLA).  The dry-run lowering waits for its slice
(ROADMAP Queue A)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import LM, Cache
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            gradients)


def train_step(model: LM, opt_state: Dict[str, Any], tokens, labels,
               opt_cfg: Optional[AdamWConfig] = None
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step on tokens, labels [B, S]: ``cfg.grad_accum``
    micro-batches of B / grad_accum rows, their gradients summed in
    float32 and averaged, and so the loss, ce and aux (one micro-batch
    passes its gradients on as they are); then AdamW, which updates the
    model's parameters in place.  ``opt_state`` is
    ``init_opt_state(dict(model.named_parameters()))``.  -> (opt_state,
    {"ce", "aux", "loss", "grad_norm", "lr"})."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = dict(model.named_parameters())
    tokens = torch.as_tensor(tokens, device=model.device)
    labels = torch.as_tensor(labels, device=model.device)
    n_micro = max(1, model.cfg.grad_accum)
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(f"train_step: batch {b} does not split into "
                         f"{n_micro} micro-batches")
    mb = b // n_micro

    def grads_of(t, l):
        loss, met = model.loss_fn(t, l)
        return loss.detach(), met, gradients(loss, params)

    if n_micro == 1:
        loss, metrics, grads = grads_of(tokens, labels)
    else:
        grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        loss, ce, aux = zero, zero, zero
        for i in range(n_micro):
            rows = slice(i * mb, (i + 1) * mb)
            l_i, met, g = grads_of(tokens[rows], labels[rows])
            for n, gi in g.items():
                grads[n].add_(gi.float())
            del g
            loss, ce, aux = loss + l_i, ce + met["ce"], aux + met["aux"]
        inv = 1.0 / n_micro
        for g in grads.values():
            g.mul_(inv)
        loss, metrics = loss * inv, {"ce": ce * inv, "aux": aux * inv}
    _, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                             opt_cfg)
    return opt_state, dict(metrics, loss=loss, **opt_metrics)


def prefill_step(model: LM, tokens) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] -> (last-position logits [B, V], cache of S)."""
    return model.prefill(tokens)


def serve_step(model: LM, cache: Cache, tokens, pos
               ) -> Tuple[torch.Tensor, Cache]:
    """One new token per row: tokens [B, 1], pos [B] -> (logits [B, V],
    cache).  The cache is updated in place."""
    return model.decode_step(cache, tokens, pos)
