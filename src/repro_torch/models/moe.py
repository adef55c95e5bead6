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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.topk import stable_topk
from repro_torch.models.layers import dense_init_

Params = Dict[str, Any]


def router_topk(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gate: (weights [..., k] renormalised, indices [..., k] int64),
    ties to the lower expert as ``lax.top_k`` breaks them."""
    lead = probs.shape[:-1]
    w, idx = stable_topk(probs.reshape(-1, probs.shape[-1]), k)
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w.reshape(*lead, k), idx.reshape(*lead, k)


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


def moe_ffn(params: Params, x: torch.Tensor, cfg: TransformerConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (output [B, S, d], aux_loss scalar f32).

    ``params``: ``router`` [d, E] (float32), ``experts`` {``w_gate``,
    ``w_up`` [E, d, f], ``w_down`` [E, f, d]} and, with shared experts,
    ``shared`` {``w_gate``, ``w_up`` [d, sf], ``w_down`` [sf, d]}."""
    b, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.top_k
    capacity = expert_capacity(s, cfg)

    # --- routing (fp32) ---
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = router_topk(probs, k)                  # [B, S, k]

    # --- aux load-balance loss (DeepSeekMoE expert-level) ---
    me = probs.mean(dim=(0, 1))
    picks = torch.zeros(e, dtype=torch.float32, device=x.device)
    picks.scatter_add_(0, gate_idx.reshape(-1),
                       torch.ones(gate_idx.numel(), device=x.device))
    fe = picks / (b * s) * (e / k)
    aux_loss = torch.sum(me * fe)

    # --- dispatch: each expert's [C, d] block of its tokens ---
    slot_pair, slot_valid, pair_slot = _dispatch_indices(
        gate_idx.reshape(b, s * k), e, capacity)
    token_of_slot = slot_pair // k                            # [B, E*C]
    x_e = torch.gather(x, 1, token_of_slot[..., None].expand(-1, -1, d))
    x_e = torch.where(slot_valid[..., None], x_e, 0)
    # [E, B*C, d]: one batched product an expert
    x_e = x_e.reshape(b, e, capacity, d).transpose(0, 1).reshape(
        e, b * capacity, d)

    # --- expert SwiGLU ---
    ex = params["experts"]
    h = F.silu(torch.bmm(x_e, ex["w_gate"])) * torch.bmm(x_e, ex["w_up"])
    y_e = torch.bmm(h, ex["w_down"])                          # [E, B*C, d]
    y_e = y_e.reshape(e, b, capacity, d).transpose(0, 1).reshape(
        b, e * capacity, d)

    # --- combine: each pair's slot, weighted, summed over the k choices ---
    y_pair = torch.gather(y_e, 1, pair_slot.clamp(min=0)[..., None].expand(
        -1, -1, d)).reshape(b, s, k, d)
    w = torch.where(pair_slot.reshape(b, s, k) >= 0, gate_w, 0.0)
    out = y_pair[:, :, 0].float() * w[..., 0, None]
    for j in range(1, k):
        out += y_pair[:, :, j].float() * w[..., j, None]
    out = out.to(x.dtype)

    # --- shared experts (always-on dense SwiGLU) ---
    if cfg.n_shared_experts:
        sp = params["shared"]
        hs = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        out = out + hs @ sp["w_down"]
    return out, aux_loss


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
