"""Fine-grained MoE (DeepSeekMoE style): shared + routed experts, top-k.

The reference's ``models/moe.py`` on one device.  Dispatch is sort-based
with a fixed capacity (no [T, E, C] one-hot): within each routing group
(a batch row), each (token, choice) pair is ranked within its expert by a
stable counting sort, and each expert receives a dense [C, d] block.  Every
expert runs over its whole capacity, as in the reference, so a step reads
every expert's weights.

Two departures, both where the reference's result is not defined:

* An expert that more pairs pick than its capacity holds keeps the first
  ``capacity`` in (token, choice) order and drops the rest.  The
  reference's ``_dispatch_indices`` writes slot 0 of that expert for each
  dropped pair (``.at[dest].set`` with ``dest`` pointing there), which
  replaces the first kept pair by token 0 on a backend where the last write
  wins; which write wins is not defined on any backend.
* The combine is a gather over each pair's slot, weighted and summed over
  the k choices in choice order (float32), not a scatter-add over slots,
  whose order of summation on the card is run-dependent.  A dropped pair
  adds nothing; in the reference it adds 0 x a value to token 0.

Routing, the aux loss and the expert einsums are the reference's, and so
are their gradients where no expert overflows: the output differentiates
through the gathers and the gate weights into the router, the aux loss
through the mean router probabilities (the expert counts, as the
reference's one-hot, carry none).

The port's own options (``TransformerConfig``; off by default, where the
layer is the reference's): ``norm_topk_prob`` False keeps the top-k
softmax weights as they are, and ``dropless`` dispatches every (token, choice) pair of the call at once,
grouped by expert with no capacity and no per-row groups: one grouped
product a projection (``torch._grouped_mm``) over the pairs sorted by
expert.  DeepSeek-V2-Lite as φ routes so (``configs/deepseek_v2_lite.py``).

Spans ``moe.route``, ``moe.experts``, ``moe.shared`` in ``moe.ffn`` while
anything records (``obs/trace.py::phases``).  Inside :func:`counting`
each layer's pairs, dropped pairs and most pairs an expert took are kept
on the device and folded into :data:`METRICS` when the block ends.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed.sharding import ShardingRules, constrain
from repro_torch.kernels.topk import stable_topk
from repro_torch.models.layers import dense_init_
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import phases

Params = Dict[str, Any]

#: the φ model's counters: ``moe.pairs``, ``moe.dropped_pairs`` and the
#: gauge ``moe.max_expert_pairs`` (the most pairs one expert took in one
#: layer of the last counted block) here; ``phi.calls``, ``phi.rows``,
#: ``phi.tokens`` from ``core/aipm.py::model_embedding_extractor``
METRICS = MetricsRegistry("phi")


class _Counting(threading.local):
    rows: Optional[List[Tuple[int, torch.Tensor, torch.Tensor]]] = None


_COUNTING = _Counting()


@contextlib.contextmanager
def counting() -> Iterator[None]:
    """Count the MoE layers this thread runs inside the block: each keeps
    (pairs, dropped pairs, most pairs an expert took) on the device, with
    no host sync; the block's end folds them into :data:`METRICS` (one
    copy to the host: end the block after the caller's own sync).  Layers
    on DTensors are not counted."""
    outer, _COUNTING.rows = _COUNTING.rows, []
    rows = _COUNTING.rows
    try:
        yield
    finally:
        _COUNTING.rows = outer
        if rows:
            got = torch.stack([torch.stack([r[1], r[2]])
                               for r in rows]).tolist()
            METRICS.counter("moe.pairs").inc(sum(r[0] for r in rows))
            METRICS.counter("moe.dropped_pairs").inc(sum(d for d, _ in got))
            METRICS.gauge("moe.max_expert_pairs").set(max(m for _, m in got))


def _count(pairs: int, dropped: torch.Tensor, most: torch.Tensor) -> None:
    """One layer's counts, kept where :func:`counting` collects (callers
    test ``_COUNTING.rows`` first: outside it nothing is computed)."""
    _COUNTING.rows.append((pairs, dropped.long(), most.long()))


def router_topk(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gate: (weights [..., k] renormalised, indices [..., k] int64),
    ties to the lower expert as ``lax.top_k`` breaks them."""
    lead = probs.shape[:-1]
    w, idx = stable_topk(probs.reshape(-1, probs.shape[-1]), k)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w.reshape(*lead, k), idx.reshape(*lead, k)


def _gate(probs: torch.Tensor, cfg: TransformerConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate weights and expert ids [..., k]: :func:`router_topk`'s,
    or under ``norm_topk_prob`` False the top-k probabilities as they are
    (the same ids)."""
    k = cfg.top_k
    if cfg.norm_topk_prob:
        w, idx = router_topk(probs, k)
    else:
        lead = probs.shape[:-1]
        w, idx = stable_topk(probs.reshape(-1, probs.shape[-1]), k)
        w, idx = w.reshape(*lead, k), idx.reshape(*lead, k)
    return w, idx


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Counting-sort dispatch of each routing group, all groups at once.

    expert_ids [G, T] (T = tokens * top_k of one group, pair t = token
    t // k, choice t % k) -> (slot_pair [G, E*C] int64, the pair each slot
    holds (0 where empty), slot_valid [G, E*C] bool, pair_slot [G, T] int64,
    the slot of each pair, -1 where it was dropped).  An expert keeps its
    first ``capacity`` pairs in pair order; the others are dropped and
    write nothing."""
    g, t = expert_ids.shape
    dev = expert_ids.device
    order = torch.argsort(expert_ids, dim=1, stable=True)   # group by expert
    sorted_e = torch.gather(expert_ids, 1, order)
    counts = torch.zeros(g, n_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, expert_ids, torch.ones_like(expert_ids))
    starts = torch.cumsum(counts, dim=1) - counts           # exclusive
    pos_in_expert = torch.arange(t, device=dev) - torch.gather(starts, 1,
                                                               sorted_e)
    keep = pos_in_expert < capacity
    n_slots = n_experts * capacity
    # kept pairs own distinct slots; dropped ones go to one spare column
    dest = torch.where(keep, sorted_e * capacity + pos_in_expert, n_slots)
    slot_pair = torch.zeros(g, n_slots + 1, dtype=torch.int64, device=dev)
    slot_pair.scatter_(1, dest, order)
    slot_valid = torch.zeros(g, n_slots + 1, dtype=torch.bool, device=dev)
    slot_valid.scatter_(1, dest, keep)
    pair_slot = torch.empty_like(order).scatter_(
        1, order, torch.where(keep, dest, -1))
    return slot_pair[:, :n_slots], slot_valid[:, :n_slots], pair_slot


def expert_capacity(s: int, cfg: TransformerConfig) -> int:
    """Slots an expert holds in a routing group of ``s`` tokens (the
    reference's float expression)."""
    return max(1, int(s * cfg.top_k / cfg.n_routed_experts
                      * cfg.capacity_factor))


def _route(probs: torch.Tensor, cfg: TransformerConfig, capacity: int):
    """Each row's routing from its router probabilities [B, S, E]: (gate
    weights [B, S, k], the expert picks counted [E] (float32), and
    ``_dispatch_indices``' slot_pair, slot_valid and pair_slot).  Rows
    route on their own."""
    b, s, _ = probs.shape
    k, n_experts = cfg.top_k, cfg.n_routed_experts
    gate_w, gate_idx = _gate(probs, cfg)                      # [B, S, k]
    picks = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    picks.scatter_add_(0, gate_idx.reshape(-1),
                       torch.ones(gate_idx.numel(), device=probs.device))
    slots = _dispatch_indices(gate_idx.reshape(b, s * k), n_experts,
                              capacity)
    return (gate_w, picks) + slots


def _experts(x: torch.Tensor, gate_w: torch.Tensor, slot_pair: torch.Tensor,
             slot_valid: torch.Tensor, pair_slot: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
             k: int, capacity: int, first: int) -> torch.Tensor:
    """The routed experts ``first`` .. ``first + w_gate.shape[0] - 1`` of
    the E a dispatch fills, on x [B, S, d]: their slots' tokens through
    each expert's SwiGLU, then each (token, choice) pair that one of them
    holds, weighted and summed over the k choices in float32 -> [B, S, d]
    in x's dtype (pairs of other experts add nothing)."""
    b, s, d = x.shape
    e = w_gate.shape[0]
    cols = slice(first * capacity, (first + e) * capacity)
    token_of_slot = slot_pair[:, cols] // k                    # [B, e*C]
    x_e = torch.gather(x, 1, token_of_slot[..., None].expand(-1, -1, d))
    x_e = torch.where(slot_valid[:, cols, None], x_e, 0)
    # [e, B*C, d]: one batched product an expert
    x_e = x_e.reshape(b, e, capacity, d).transpose(0, 1).reshape(
        e, b * capacity, d)

    # --- expert SwiGLU ---
    h = F.silu(torch.bmm(x_e, w_gate)) * torch.bmm(x_e, w_up)
    y_e = torch.bmm(h, w_down)                                # [e, B*C, d]
    y_e = y_e.reshape(e, b, capacity, d).transpose(0, 1).reshape(
        b, e * capacity, d)

    # --- combine: each pair's slot, weighted, summed over the k choices ---
    local = pair_slot - first * capacity
    held = (local >= 0) & (local < e * capacity)
    y_pair = torch.gather(y_e, 1, torch.where(held, local, 0)[..., None]
                          .expand(-1, -1, d)).reshape(b, s, k, d)
    w = torch.where(held.reshape(b, s, k), gate_w, 0.0)
    out = y_pair[:, :, 0].float() * w[..., 0, None]
    for j in range(1, k):
        out += y_pair[:, :, j].float() * w[..., j, None]
    return out.to(x.dtype)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """x [P, a] rows grouped by expert (expert e's rows end at ends[e],
    int32, cumulative) times w [E, a, b] -> [P, b]: one grouped product
    (``torch._grouped_mm``).  The card's takes bf16 only; another dtype
    there takes one product an expert."""
    if x.is_cuda and x.dtype != torch.bfloat16:
        out = x.new_empty(x.shape[0], w.shape[-1])
        start = 0
        for e, end in enumerate(ends.tolist()):
            torch.mm(x[start:end], w[e], out=out[start:end])
            start = end
        return out
    return torch._grouped_mm(x, w, offs=ends)


def shared_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """The shared experts, one SwiGLU of their summed width."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _dropless(x: torch.Tensor, gate_w: torch.Tensor, gate_idx: torch.Tensor,
              ex: Params, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (token, choice) pair of x [B, S, d] through its expert, no
    capacity: the pairs sorted by expert (stable), each expert's SwiGLU as
    one grouped product a projection, its hidden row scaled by the pair's
    gate weight (the down projection is linear), the k choices of a token
    summed in float32 and rounded once -> (output [B, S, d] in x's dtype,
    pairs an expert [E] int64)."""
    b, s, d = x.shape
    k = gate_idx.shape[-1]
    flat = gate_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    ends = torch.cumsum(counts, 0).to(torch.int32)
    xs = x.reshape(b * s, d).index_select(0, order // k)
    h = F.silu(grouped_mm(xs, ex["w_gate"], ends)) \
        * grouped_mm(xs, ex["w_up"], ends)
    h *= gate_w.reshape(-1)[order, None].to(h.dtype)
    ys = grouped_mm(h, ex["w_down"], ends)
    y = torch.empty_like(ys).index_copy_(0, order, ys).view(b, s, k, d)
    return y.sum(dim=2), counts         # accumulated in float32


def moe_ffn(params: Params, x: torch.Tensor, cfg: TransformerConfig,
            rules: Optional[ShardingRules] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (output [B, S, d], aux_loss scalar f32).

    ``params``: ``router`` [d, E] (float32), ``experts`` {``w_gate``,
    ``w_up`` [E, d, f], ``w_down`` [E, f, d]} and, with shared experts,
    ``shared`` {``w_gate``, ``w_up`` [d, sf], ``w_down`` [sf, d]}.

    On DTensors (x sharded by rows, the experts by ``expert``) the routing
    and each rank's experts run on the local shards (:func:`_on_shards`),
    and the combined output, a partial sum over the expert-sharding mesh
    dims, is constrained to ``("batch", None, "embed")``: the reference's
    all-reduce of the combine.  ``local_map`` fixes the dispatch's
    placements, so the reference's three constraints inside the dispatch
    have no counterpart here."""
    b, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.top_k
    capacity = expert_capacity(s, cfg)
    ex = params["experts"]

    with phases(None, "moe.ffn") as ph:
        if ph:
            ph.next("moe.route")
        # --- routing (fp32) ---
        logits = x.float() @ params["router"].float()
        probs = torch.softmax(logits, dim=-1)
        if isinstance(x, DTensor):
            if cfg.dropless:
                raise NotImplementedError(
                    "moe_ffn: dropless routing runs on one device")
            if ph:
                ph.next("moe.experts")
            out, picks = _on_shards(x, probs, ex, cfg, capacity)
        elif cfg.dropless:
            gate_w, gate_idx = _gate(probs, cfg)
            if ph:
                ph.next("moe.experts")
            out, counts = _dropless(x, gate_w, gate_idx, ex, e)
            picks = counts.float()
            if _COUNTING.rows is not None:
                _count(gate_idx.numel(), gate_idx.numel() - counts.sum(),
                       counts.max())
        else:
            gate_w, picks, slot_pair, slot_valid, pair_slot = _route(
                probs, cfg, capacity)
            if ph:
                ph.next("moe.experts")
            out = _experts(x, gate_w, slot_pair, slot_valid, pair_slot,
                           ex["w_gate"], ex["w_up"], ex["w_down"], k,
                           capacity, 0)
            if _COUNTING.rows is not None:
                # the pairs each expert was given in each row, before its
                # capacity
                ids = _gate(probs, cfg)[1].reshape(b, s * k)
                loads = torch.zeros(b, e, dtype=torch.int64,
                                    device=ids.device).scatter_add_(
                    1, ids, torch.ones_like(ids))
                _count(pair_slot.numel(), (pair_slot < 0).sum(), loads.max())
        out = constrain(out, rules, "batch", None, "embed")

        # --- aux load-balance loss (DeepSeekMoE expert-level) ---
        me = probs.mean(dim=(0, 1))
        fe = picks / (b * s) * (e / k)
        aux_loss = torch.sum(me * fe)

        # --- shared experts (always-on dense SwiGLU) ---
        if cfg.n_shared_experts:
            if ph:
                ph.next("moe.shared")
            sp = params["shared"]
            out = out + shared_experts(x, sp["w_gate"], sp["w_up"],
                                       sp["w_down"])
    return out, aux_loss


def _on_shards(x, probs, ex: Params, cfg: TransformerConfig, capacity: int):
    """The routed experts on DTensors: each rank routes its rows of x (rows
    route on their own, so the routing is local) and runs the experts it
    holds (``w_*`` sharded on their expert dim; any other sharding, an
    FSDP one, is gathered explicitly) -> (the combine, a ``Partial`` sum
    over the expert-sharding mesh dims, and the picks, a ``Partial`` sum
    over x's row-sharding mesh dims)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels import sharded

    k, n_experts = cfg.top_k, cfg.n_routed_experts
    mesh = x.device_mesh
    x = sharded.keep_only(x, (0,))
    probs = sharded.follow(probs, x, {0: 0})
    rows = list(x.placements)
    # the FSDP sharding of the experts' weights gathered (their expert dim
    # stays sharded)
    w = {}
    for n in ("w_gate", "w_up", "w_down"):
        t = ex[n]
        t = sharded.unshard(t, [i for i, p in enumerate(t.placements)
                                if isinstance(p, Shard) and p.dim != 0])
        w[n] = sharded.keep_only(t, (0,))
    by_expert = [i for i, p in enumerate(w["w_gate"].placements)
                 if isinstance(p, Shard)]
    if any(isinstance(rows[i], Shard) for i in by_expert):
        raise ValueError("moe_ffn on shards: a mesh dim shards both the "
                         "rows and the experts")
    for n in ("w_up", "w_down"):
        w[n] = sharded.to(w[n], w["w_gate"].placements)
    first = sharded.offset(w["w_gate"], 0)
    summed = [Partial() if isinstance(p, Shard) else Replicate()
              for p in rows]
    route = local_map(
        lambda p: _route(p, cfg, capacity),
        out_placements=(rows, summed, rows, rows, rows),
        in_placements=(rows,), device_mesh=mesh)
    gate_w, picks, slot_pair, slot_valid, pair_slot = route(probs)
    out_pl = sharded.partial_where(rows, by_expert)
    w_pl = list(w["w_gate"].placements)
    w_grad = [p if isinstance(p, Shard) else
              Partial() if isinstance(rows[i], Shard) else Replicate()
              for i, p in enumerate(w_pl)]
    experts = local_map(
        lambda xl, gw, sp, sv, ps, wg, wu, wd: _experts(
            xl, gw, sp, sv, ps, wg, wu, wd, k, capacity, first),
        out_placements=(out_pl,),
        in_placements=(rows, rows, rows, rows, rows, w_pl, w_pl, w_pl),
        in_grad_placements=(out_pl, out_pl, rows, rows, rows, w_grad,
                            w_grad, w_grad),
        device_mesh=mesh)
    out = experts(x, gate_w, slot_pair, slot_valid, pair_slot,
                  w["w_gate"], w["w_up"], w["w_down"])
    return out, picks


def moe_param_shapes(cfg: TransformerConfig
                     ) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """One MoE layer's weights under flat names: name -> (shape, fan-in).
    The router is float32; the shared experts' weights are ``shared_*``
    (:func:`moe_param_path` maps a name into ``moe_ffn``'s layout)."""
    d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
    p = {"router": ((d, e), d), "w_gate": ((e, d, f), d),
         "w_up": ((e, d, f), d), "w_down": ((e, f, d), f)}
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * f
        p.update(shared_w_gate=((d, sf), d), shared_w_up=((d, sf), d),
                 shared_w_down=((sf, d), sf))
    return p


def moe_param_path(name: str) -> Tuple[str, ...]:
    """Where a flat name of :func:`moe_param_shapes` sits in ``moe_ffn``'s
    (and the reference's) nested params."""
    if name == "router":
        return (name,)
    if name.startswith("shared_"):
        return ("shared", name[len("shared_"):])
    return ("experts", name)


def nest_moe_params(flat: Dict[str, torch.Tensor]) -> Params:
    """Flat names -> ``moe_ffn``'s nested params."""
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        *groups, leaf = moe_param_path(name)
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = t
    return out


def init_moe_params(cfg: TransformerConfig, dtype: torch.dtype,
                    device: torch.device,
                    generator: Optional[torch.Generator] = None) -> Params:
    """One MoE layer's parameters, drawn as the reference draws them: a
    float32 router, truncated-normal fan-in expert matrices in ``dtype``."""
    return nest_moe_params({
        name: dense_init_(torch.empty(shape, dtype=torch.float32
                                      if name == "router" else dtype,
                                      device=device), fan, generator)
        for name, (shape, fan) in moe_param_shapes(cfg).items()})


def moe_param_axes(cfg: TransformerConfig) -> Dict:
    axes = {
        "router": ("p_embed", None),
        "experts": {
            "w_gate": ("p_expert", "p_embed", None),
            "w_up": ("p_expert", "p_embed", None),
            "w_down": ("p_expert", None, "p_embed"),
        },
    }
    if cfg.n_shared_experts:
        axes["shared"] = {
            "w_gate": ("p_embed", "p_mlp"),
            "w_up": ("p_embed", "p_mlp"),
            "w_down": ("p_mlp", "p_embed"),
        }
    return axes
