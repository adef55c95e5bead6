"""The Mellum2 cell's weights: drawn by the benchmark from the seed, loaded
into the program's model, and drawn again, a layer at a time, for the plain
reference (``mellum2_ref.py``), so the comparison takes no weight from the
program.

The draw is ``phi_weights``' (each tensor from a generator of its own,
seeded by (seed, layer, the tensor's place in the layer), float32 on the
run's device, rounded to the configuration's ``torch_dtype``), over
Mellum2's tensors under the reference's names and layouts.  No checkpoint
can be loaded here, so the scales are assumed (the configuration's
``assumed``): fan-in normal matrices, a unit-normal embedding, unit norm
scales, and a router whose logits have a standard deviation of
``phi_weights.ROUTER_STD`` (3) on a normalised token, so that the top 8 of
64 experts take about 90% of the softmax gate before it is renormalised
(a fan-in router, logit std 1, would give them about 43%: a gate spread
over most of the 64, as no trained router is).
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.phi_weights import Shapes, _draw


def top_shapes(cfg: dict) -> Shapes:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed": ((v, d), 1), "final_norm": ((d,), 0),
            "lm_head": ((d, v), d)}


def layer_shapes(cfg: dict) -> Shapes:
    """A layer's weights: GQA attention, then the sparse MoE (every layer of
    ``mlp_layer_types`` is one)."""
    d, h, kvh = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, e, f = cfg["head_dim"], cfg["num_experts"], \
        cfg["moe_intermediate_size"]
    return {"ln1": ((d,), 0), "ln2": ((d,), 0),
            "wq": ((d, h, hd), d), "wk": ((d, kvh, hd), d),
            "wv": ((d, kvh, hd), d), "wo": ((h, hd, d), h * hd),
            "router": ((d, e), None), "w_gate": ((e, d, f), d),
            "w_up": ((e, d, f), d), "w_down": ((e, f, d), f)}


def top(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and the head."""
    return _draw(cfg, top_shapes(cfg), seed, 0, device)


def layer(cfg: dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights, in the configuration's dtype."""
    return _draw(cfg, layer_shapes(cfg), seed, 1 + i, device)


@torch.no_grad()
def load(cfg: dict, seed: int, lm) -> None:
    """Write the drawn weights into the program's ``LM`` (its ``embed``,
    ``final_norm``, ``lm_head`` and its MoE layer stack, a layer's weights
    under the reference's names); raise where a name or a shape differs,
    so no weight keeps the program's own init."""
    dev = lm.embed.device
    for name, t in top(cfg, seed, dev).items():
        getattr(lm, name).copy_(t)
    stack = lm.moe_layers
    if lm.n_dense or stack is None:
        raise ValueError("mellum2_weights: every layer is MoE, the program "
                         f"holds {lm.n_dense} dense ones")
    for i in range(cfg["num_hidden_layers"]):
        drawn = layer(cfg, seed, i, dev)
        if set(drawn) != set(stack.keys()):
            raise ValueError(f"layer {i}: the program holds "
                             f"{sorted(stack.keys())}, the reference "
                             f"{sorted(drawn)}")
        for name, t in drawn.items():
            if stack[name][i].shape != t.shape:
                raise ValueError(f"layer {i} {name}: the program's "
                                 f"{tuple(stack[name][i].shape)}, the "
                                 f"reference's {tuple(t.shape)}")
            stack[name][i].copy_(t)
        del drawn
