"""RecSys steps (AutoInt x 4 shapes), the reference's
``launch/recsys_steps.py`` -- one card runs them eagerly, and
``recsys_bundle`` wraps each in a ``StepBundle`` for a mesh.

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

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchSpec, RecsysShape
from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (ShardingRules, base_rules,
                                              mesh_axes)
from repro_torch.launch.mesh import ONE as ONE_DEVICE
from repro_torch.launch.mesh import mesh_size
from repro_torch.models.recsys.autoint import AutoInt
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            gradients, init_opt_state,
                                            opt_state_axes)

#: the reference's recsys optimizer (``recsys_steps.py:64``)
OPT = AdamWConfig(lr=1e-3, weight_decay=0.0)


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


def recsys_bundle(spec: ArchSpec, shape: RecsysShape, mesh: Any,
                  rule_overrides: Optional[Dict[str, Any]] = None):
    """The recsys cell's ``StepBundle`` (the reference's
    ``recsys_bundle``): AutoInt on meta over the fields padded for
    ``mesh``; train ``fn(model, opt_state, ids, labels)`` -> (parameters,
    opt_state, {"loss", "grad_norm", "lr"}), serve ``fn(model, ids)`` ->
    logits, retrieval ``fn(model, query_ids, cand_reps)`` -> (scores,
    rows) over ``n_candidates`` padded to twice the mesh's devices."""
    from repro_torch.launch.steps import StepBundle, tree_specs

    cfg = spec.model
    f_pad = fields_padded(spec, mesh)
    model = recsys_model(spec, mesh, device="meta")
    rules = recsys_rules(mesh)
    if rule_overrides:
        rules = rules.with_overrides(**rule_overrides)
    p_axes = model.param_axes()
    p_specs = tree_specs(rules, p_axes)
    h, b = cfg.multi_hot, shape.batch

    def meta(*shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    ids_spec = rules.spec("batch", None, None)
    if shape.kind == "train":
        def train_fn(model, opt_state, ids, labels):
            opt_state, met = recsys_train_step(model, opt_state, ids, labels)
            return dict(model.named_parameters()), opt_state, met

        met_specs = {k: rules.spec() for k in ("loss", "grad_norm", "lr")}
        o_specs = tree_specs(rules, opt_state_axes(p_axes))
        return StepBundle(
            fn=train_fn,
            abstract_args=(model,
                           init_opt_state(dict(model.named_parameters())),
                           meta(b, f_pad, h),
                           meta(b, dtype=torch.float32)),
            in_specs=(p_specs, o_specs, ids_spec, rules.spec("batch")),
            out_specs=(p_specs, o_specs, met_specs),
            rules=rules, donate_argnums=(0, 1),
            meta={"kind": "recsys_train", "f_pad": f_pad},
        )

    if shape.kind == "serve":
        return StepBundle(
            fn=recsys_serve_step,
            abstract_args=(model, meta(b, f_pad, h)),
            in_specs=(p_specs, ids_spec),
            out_specs=rules.spec("batch"),
            rules=rules,
            meta={"kind": "recsys_serve", "f_pad": f_pad},
        )

    # retrieval: 1 query against n_candidates item representations
    n_cand = _pad_to(shape.n_candidates, mesh_size(mesh) * 2)
    return StepBundle(
        fn=recsys_retrieval_step,
        abstract_args=(model, meta(1, f_pad, h),
                       meta(n_cand, model.d_repr, dtype=torch.float32)),
        in_specs=(p_specs, rules.spec(None, None, None),
                  rules.spec("candidate", None)),
        out_specs=(rules.spec(), rules.spec()),
        rules=rules,
        meta={"kind": "recsys_retrieval", "n_cand": n_cand},
    )
