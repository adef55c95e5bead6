"""The LM's step functions and the step bundles, the reference's
``launch/steps.py``.

``train_step``, ``prefill_step`` and ``serve_step`` run one step eagerly on
one device, for every LM config (dense, MoE, MLA).  ``build_step(arch,
shape, mesh)`` wraps a cell's step in a :class:`StepBundle`: the step
function, its arguments on the ``meta`` device (the model built there, the
optimizer state, tokens and cache as meta tensors: nothing allocated), and
each argument's and output's partition spec from the cell's sharding
rules.  The dry run (``launch/dryrun.py``) counts a bundle's operations on
meta; on a production mesh it places the arguments as DTensors by their
specs (``distributed/sharding.py::place_tree``) and the step runs on them,
the model constraining its activations by the bundle's rules
(``LM.rules``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchSpec, get_arch
from repro_torch.configs.base import LMShape
from repro_torch.distributed.sharding import (ShardingRules, base_rules,
                                              decode_rules, mesh_axes)
from repro_torch.launch.op_analysis import repeat
from repro_torch.models.transformer import LM, Cache
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            gradients, init_opt_state,
                                            opt_state_axes)


def train_step(model: LM, opt_state: Dict[str, Any], tokens, labels,
               opt_cfg: Optional[AdamWConfig] = None
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step on tokens, labels [B, S]: ``cfg.grad_accum``
    micro-batches of B / grad_accum rows, their gradients summed in
    float32 and averaged, and so the loss, ce and aux (one micro-batch
    passes its gradients on as they are); then AdamW, which updates the
    model's parameters in place.  ``opt_state`` is
    ``init_opt_state(dict(model.named_parameters()))``.  -> (opt_state,
    {"ce", "aux", "loss", "grad_norm", "lr"}).  On meta tensors the
    micro-batches are identical in all but values: one runs, counted
    ``grad_accum`` times by an operation count (``op_analysis.repeat``).

    On DTensors (the dry run on a mesh) micro-batch i is each rank's i-th
    slice of its own rows, taken locally, and the summed gradients, partial
    sums over the batch's mesh dims, are reduced to their parameters'
    placements once, by the optimizer (``reduce_gradients``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = dict(model.named_parameters())
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(tokens, device=model.device)
        labels = torch.as_tensor(labels, device=model.device)
    n_micro = max(1, model.cfg.grad_accum)
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(f"train_step: batch {b} does not split into "
                         f"{n_micro} micro-batches")

    def grads_of(t, l):
        loss, met = model.loss_fn(t, l)
        return loss.detach(), met, gradients(loss, params)

    if n_micro == 1:
        loss, metrics, grads = grads_of(tokens, labels)
    else:
        grads = {}
        zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
        loss, ce, aux = zero, zero, zero
        runs = 1 if tokens.device.type == "meta" else n_micro
        with repeat(n_micro // runs):
            for i in range(runs):
                l_i, met, g = grads_of(micro_rows(tokens, i, n_micro),
                                       micro_rows(labels, i, n_micro))
                for n, gi in g.items():
                    if n in grads:
                        grads[n].add_(gi.float())
                    else:
                        grads[n] = gi.to(torch.float32, copy=True)
                del g
                loss, ce, aux = loss + l_i, ce + met["ce"], aux + met["aux"]
        inv = 1.0 / n_micro
        for g in grads.values():
            g.mul_(inv)
        loss, metrics = loss * inv, {"ce": ce * inv, "aux": aux * inv}
    _, opt_state, opt_metrics = adamw_update(grads, opt_state, params,
                                             opt_cfg)
    return opt_state, dict(metrics, loss=loss, **opt_metrics)


def micro_rows(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``n`` of a batch's rows: rows i*B/n .. of a
    tensor; of a DTensor, each rank's i-th slice of its own rows, taken
    locally (on a mesh of one rank the same rows).  On meta a rank that
    holds fewer rows than micro-batches takes one row a micro-batch (the
    reference's partitioner pads such a micro-batch to a row a device)."""
    if not isinstance(t, DTensor):
        mb = t.shape[0] // n
        return t[i * mb:(i + 1) * mb]
    from torch.distributed.tensor.experimental import local_map

    def take(x):
        if x.shape[0] < n and x.device.type != "meta":
            raise ValueError(f"train_step: {x.shape[0]} rows on this rank "
                             f"for {n} micro-batches")
        mb = -(-x.shape[0] // n)
        return x[i * mb:(i + 1) * mb]
    return local_map(take, out_placements=(t.placements,),
                     in_placements=(t.placements,),
                     device_mesh=t.device_mesh)(t)


def prefill_step(model: LM, tokens) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] -> (last-position logits [B, V], cache of S)."""
    return model.prefill(tokens)


def serve_step(model: LM, cache: Cache, tokens, pos
               ) -> Tuple[torch.Tensor, Cache]:
    """One new token per row: tokens [B, 1], pos [B] -> (logits [B, V],
    cache).  The cache is updated in place."""
    return model.decode_step(cache, tokens, pos)


# ---------------------------------------------------------------------------
# step bundles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepBundle:
    """One (arch x shape) cell's step on a mesh.  ``fn`` takes
    ``abstract_args`` positionally: the model first (built on ``meta``;
    its parameters are the reference's params), then the optimizer state,
    the batch or the cache, as meta tensors.  ``in_specs`` and
    ``out_specs`` mirror the arguments and outputs with each tensor's
    partition spec (a tuple, the reference's ``PartitionSpec``; the model's
    keyed by ``named_parameters()`` names)."""

    fn: Callable
    abstract_args: Tuple[Any, ...]
    in_specs: Tuple[Any, ...]
    out_specs: Any
    rules: ShardingRules
    donate_argnums: Tuple[int, ...] = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _is_axes(x: Any) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


def tree_specs(rules: ShardingRules, axes_tree: Any) -> Any:
    """A tree of logical-axis tuples (or None) -> the same tree of
    partition specs."""
    if _is_axes(axes_tree):
        return rules.spec(*(axes_tree or ()))
    if isinstance(axes_tree, dict):
        return {k: tree_specs(rules, v) for k, v in axes_tree.items()}
    return type(axes_tree)(tree_specs(rules, v) for v in axes_tree)


def flat_leaves(arg: Any, spec: Any, prefix: str = ""
                ) -> Dict[str, Tuple[torch.Tensor, Any]]:
    """{path: (tensor, its spec)} of an argument (a model's parameters, a
    dict, a tuple or a tensor) and its spec tree."""
    if isinstance(arg, torch.nn.Module):
        arg = dict(arg.named_parameters())
    if isinstance(arg, torch.Tensor):
        return {prefix: (arg, spec)}
    items = arg.items() if isinstance(arg, dict) else enumerate(arg)
    out: Dict[str, Tuple[torch.Tensor, Any]] = {}
    for k, v in items:
        out.update(flat_leaves(v, spec[k], f"{prefix}/{k}" if prefix
                               else str(k)))
    return out


def _axis_size(mesh: Any, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def lm_rules(cfg, shape: LMShape, mesh: Any) -> ShardingRules:
    """Config-aware rules: a parameter axis that does not divide its mesh
    axis falls back to replicated (the reference's ``lm_rules``)."""
    msize = _axis_size(mesh, "model")
    dsize = _axis_size(mesh, "data")
    psize = _axis_size(mesh, "pod")
    heads_ok = cfg.n_heads % msize == 0
    kvh_ok = (not cfg.is_mla) and cfg.n_kv_heads % msize == 0

    if shape.kind == "decode":
        b = shape.global_batch
        shard_seq_over_data = b < psize * dsize
        r = decode_rules(mesh, shard_seq_over_data=shard_seq_over_data)
        over: Dict[str, Any] = {}
        if shard_seq_over_data:
            # batch too small for any DP axis: replicate batch, spread the
            # KV sequence over every axis
            kv_axes = tuple(a for a in ("pod", "data", "model")
                            if _axis_size(mesh, a) > 1)
            if b % max(psize, 1) != 0:
                over["batch"] = None
            over["kv_seq"] = kv_axes
        if cfg.is_mla and heads_ok:
            over["heads"] = "model" if msize > 1 else None
        if not heads_ok:
            over["p_heads"] = None
        if not kvh_ok:
            over["p_kv_heads"] = None
        return r.with_overrides(**over)

    # train / prefill
    fsdp = cfg.fsdp and shape.kind == "train"
    r = base_rules(mesh, fsdp=fsdp)
    over = {}
    if not heads_ok:
        over["p_heads"] = None
    if not kvh_ok:
        over["p_kv_heads"] = None
        over["kv_heads"] = None
    if shape.kind == "prefill":
        # prefill emits the cache seq-sharded so decode can consume it
        over["kv_seq"] = "model" if msize > 1 else None
    return r.with_overrides(**over)


def _meta_tokens(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _lm_bundle(spec: ArchSpec, shape: LMShape, mesh: Any,
               extra: Optional[Dict[str, Any]] = None) -> StepBundle:
    cfg = spec.model
    model = LM(cfg, device="meta")
    rules = lm_rules(cfg, shape, mesh)
    if extra:
        rules = rules.with_overrides(**extra)
    model.rules = rules
    p_axes = model.param_axes()
    p_specs = tree_specs(rules, p_axes)
    b, s = shape.global_batch, shape.seq_len
    tok_spec = rules.spec("batch", "seq")
    logits_spec = rules.spec("batch", "vocab")

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        n_micro = max(1, cfg.grad_accum)
        assert b % n_micro == 0, (b, n_micro)

        def train_fn(model, opt_state, tokens, labels):
            opt_state, metrics = train_step(model, opt_state, tokens, labels,
                                            opt_cfg)
            return dict(model.named_parameters()), opt_state, metrics

        o_specs = tree_specs(rules, opt_state_axes(p_axes))
        met_specs = {k: rules.spec() for k in
                     ("ce", "aux", "loss", "grad_norm", "lr")}
        return StepBundle(
            fn=train_fn,
            abstract_args=(model,
                           init_opt_state(dict(model.named_parameters())),
                           _meta_tokens(b, s), _meta_tokens(b, s)),
            in_specs=(p_specs, o_specs, tok_spec, tok_spec),
            out_specs=(p_specs, o_specs, met_specs),
            rules=rules,
            donate_argnums=(0, 1),
            meta={"kind": "train"},
        )

    cache_specs = tree_specs(rules, model.cache_axes())
    if shape.kind == "prefill":
        return StepBundle(
            fn=prefill_step,
            abstract_args=(model, _meta_tokens(b, s)),
            in_specs=(p_specs, tok_spec),
            out_specs=(logits_spec, cache_specs),
            rules=rules,
            meta={"kind": "prefill"},
        )

    return StepBundle(
        fn=serve_step,
        abstract_args=(model, model.cache_spec(b, s), _meta_tokens(b, 1),
                       _meta_tokens(b)),
        in_specs=(p_specs, cache_specs, rules.spec("batch", None),
                  rules.spec("batch")),
        out_specs=(logits_spec, cache_specs),
        rules=rules,
        donate_argnums=(1,),
        meta={"kind": "decode"},
    )


def build_step(arch: str, shape_name: str, mesh: Any,
               rule_overrides: Optional[Dict[str, Any]] = None,
               cfg_overrides: Optional[Dict[str, Any]] = None) -> StepBundle:
    """The bundle of ``arch`` at its shape ``shape_name`` on ``mesh`` (a
    ``DeviceMesh`` or a stand-in, ``launch/mesh.py``), with the rules and
    the model config overridden where given."""
    spec = get_arch(arch)
    if cfg_overrides:
        spec = dataclasses.replace(
            spec, model=dataclasses.replace(spec.model, **cfg_overrides))
    shape = spec.shape(shape_name)
    if spec.family == "lm":
        return _lm_bundle(spec, shape, mesh, rule_overrides)
    if spec.family == "gnn":
        from repro_torch.launch.gnn_steps import gnn_bundle
        return gnn_bundle(spec, shape, mesh, rule_overrides)
    if spec.family == "recsys":
        from repro_torch.launch.recsys_steps import recsys_bundle
        return recsys_bundle(spec, shape, mesh, rule_overrides)
    raise ValueError(f"unknown family {spec.family}")
