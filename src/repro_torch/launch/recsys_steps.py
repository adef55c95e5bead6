"""RecSys steps (AutoInt x 4 shapes), the reference's
``launch/recsys_steps.py`` without meshes, shardings or abstract shapes --
one card runs them eagerly.

  * train_batch     -> ``recsys_train_step`` (BCE + AdamW) on [65536, F, H]
                       multi-hot ids
  * serve_p99/bulk  -> ``recsys_serve_step``: the logits
  * retrieval_cand  -> ``recsys_retrieval_step``: 1 query vs 1M candidate
                       representations, inner product + top-k through the
                       ``ivf_scan`` kernel

The reference field-shards the tables over ``model``, padding the 39
fields to a multiple of the axis (``fields_padded``); the field mask keeps
the padded fields inert.  ``recsys_rules`` reads only a mesh's axis names
and sizes (a ``DeviceMesh`` or a stand-in with ``axis_names`` and a
``shape`` mapping), as ``gnn_steps.gnn_rules`` does.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (ShardingRules, base_rules,
                                              mesh_axes)
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            gradients)

#: the reference's recsys optimizer (``recsys_steps.py:64``)
OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)

#: one device, the reference's smoke-mesh axes
ONE_DEVICE = SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 1, "model": 1})


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def recsys_rules(mesh: Any) -> ShardingRules:
    r = base_rules(mesh)
    axes = mesh_axes(mesh)
    has = lambda a: axes.get(a, 1) > 1  # noqa: E731
    return r.with_overrides(
        field="model" if has("model") else None,
        candidate=(tuple(a for a in ("data", "model") if has(a)) or None),
    )


def fields_padded(spec: ArchSpec, mesh: Any = ONE_DEVICE) -> int:
    """The fields of ``spec``'s tables padded to a multiple of the mesh's
    ``model`` axis (the reference's ``f_pad``)."""
    msize = mesh_axes(mesh).get("model", 1)
    return _pad_to(spec.model.n_sparse, max(msize, 1))


def recsys_model(spec: ArchSpec, mesh: Any = ONE_DEVICE,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None) -> AutoInt:
    """``spec``'s AutoInt over the fields padded for ``mesh``, on
    ``device`` (default: the CUDA card)."""
    return AutoInt(spec.model, fields_padded(spec, mesh), device=device,
                   generator=generator)


def field_mask(model: AutoInt) -> torch.Tensor:
    """[F] float32 on the model's device: 1 on a real field, 0 on
    padding."""
    return (torch.arange(model.f, device=model.device)
            < model.f_real).to(torch.float32)


def recsys_train_step(model: AutoInt, opt_state: Dict[str, Any],
                      ids: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step of ``model`` on ids [B, F, H] and labels [B]:
    the clipped BCE, its gradients by autograd (the tables' through the
    embedding bag's kernel), then AdamW (lr 1e-3, no weight decay), which
    updates the parameters in place.  ``opt_state`` is
    ``init_opt_state(dict(model.named_parameters()))``.  -> (opt_state,
    {"loss", "grad_norm", "lr"})."""
    params = dict(model.named_parameters())
    loss = model.loss_fn(ids, labels, field_mask(model))
    grads = gradients(loss, params)
    _, opt_state, om = adamw_update(grads, opt_state, params, OPT)
    return opt_state, {"loss": loss.detach(), **om}


@torch.no_grad()
def recsys_serve_step(model: AutoInt, ids: torch.Tensor) -> torch.Tensor:
    """The logits [B] of ids [B, F, H]."""
    return model.logits(ids, field_mask(model))


def recsys_retrieval_step(model: AutoInt, query_ids: torch.Tensor,
                          cand_reps: torch.Tensor, k: int = 100
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query [1, F, H] against the candidates' representations [N,
    F d_attn] -> (scores [k], rows [k] int32), in ``lax.top_k`` order."""
    return model.score_candidates(query_ids, cand_reps, k,
                                  field_mask(model))
