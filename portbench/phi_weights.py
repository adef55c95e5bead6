"""The φ cell's weights: drawn by the benchmark from the seed, loaded into
the program's model, and drawn again, a layer at a time, for the plain
reference, so the comparison takes no weight from the program.

Each tensor is drawn in float32 on the run's device from a generator of
its own, seeded by (seed, layer, the tensor's place in the layer), and
rounded to the configuration's ``torch_dtype``: the same seed gives the
same values, in any order of drawing.  Names and layouts are the plain
reference's (``deepseek_v2_ref.py``), read from the configuration's
published keys.  No checkpoint can be loaded here, so the scales are
assumed (the configuration's ``assumed``): fan-in normal matrices, a
unit-normal embedding, unit norm scales, and a router whose logits have a
standard deviation of ``ROUTER_STD`` on a normalised token, so that the
top 6 of 64 experts take about 86% of the gate on average and the routed
experts carry a share of each layer like the shared ones' (a fan-in
router would give them about 36%).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

ROUTER_STD = 3.0

#: name -> (shape, fan-in; 0 for a norm scale of ones, None for the router)
Shapes = Dict[str, Tuple[Tuple[int, ...], object]]


def top_shapes(cfg: dict) -> Shapes:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return {"embed": ((v, d), 1), "final_norm": ((d,), 0),
            "lm_head": ((d, v), d)}


def layer_shapes(cfg: dict, i: int) -> Shapes:
    """Layer ``i``'s weights (MLA without q-LoRA; dense below
    ``first_k_dense_replace``, else MoE)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, dc = cfg["v_head_dim"], cfg["kv_lora_rank"]
    out: Shapes = {"ln1": ((d,), 0), "ln2": ((d,), 0),
                   "wq": ((d, h, dn + dr), d), "wkv_a": ((d, dc + dr), d),
                   "kv_a_norm": ((dc,), 0), "wkv_b": ((dc, h, dn + dv), dc),
                   "wo": ((h, dv, d), h * dv)}
    if i < cfg["first_k_dense_replace"]:
        f = cfg["intermediate_size"]
        out.update(w_gate=((d, f), d), w_up=((d, f), d), w_down=((f, d), f))
        return out
    e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    sf = cfg["n_shared_experts"] * f
    out.update(router=((d, e), None), w_gate=((e, d, f), d),
               w_up=((e, d, f), d), w_down=((e, f, d), f))
    if sf:
        out.update(shared_w_gate=((d, sf), d), shared_w_up=((d, sf), d),
                   shared_w_down=((sf, d), sf))
    return out


def _draw(cfg: dict, shapes: Shapes, seed: int, where: int,
          device) -> Dict[str, torch.Tensor]:
    dtype = getattr(torch, cfg["torch_dtype"])
    d = cfg["hidden_size"]
    out = {}
    for j, (name, (shape, fan)) in enumerate(shapes.items()):
        if fan == 0:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        state = np.random.SeedSequence([int(seed), 11, where, j]) \
            .generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state) >> 1)
        std = ROUTER_STD / d ** 0.5 if fan is None else fan ** -0.5
        t = torch.randn(shape, generator=gen, device=device)
        out[name] = t.mul_(std).to(dtype)
        del t
    return out


def top(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and the head."""
    return _draw(cfg, top_shapes(cfg), seed, 0, device)


def layer(cfg: dict, seed: int, i: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights, in the configuration's dtype."""
    return _draw(cfg, layer_shapes(cfg, i), seed, 1 + i, device)


@torch.no_grad()
def load(cfg: dict, seed: int, lm) -> None:
    """Write the drawn weights into the program's ``LM`` (its ``embed``,
    ``final_norm``, ``lm_head`` and its dense and MoE layer stacks, a
    layer's weights under the reference's names); raise where a name or a
    shape differs, so no weight keeps the program's own init."""
    dev = lm.embed.device
    for name, t in top(cfg, seed, dev).items():
        getattr(lm, name).copy_(t)
    n_dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        stack, j = (lm.layers, i) if i < n_dense else (lm.moe_layers,
                                                       i - n_dense)
        drawn = layer(cfg, seed, i, dev)
        if set(drawn) != set(stack.keys()):
            raise ValueError(f"layer {i}: the program holds "
                             f"{sorted(stack.keys())}, the reference "
                             f"{sorted(drawn)}")
        for name, t in drawn.items():
            if stack[name][j].shape != t.shape:
                raise ValueError(f"layer {i} {name}: the program's "
                                 f"{tuple(stack[name][j].shape)}, the "
                                 f"reference's {tuple(t.shape)}")
            stack[name][j].copy_(t)
        del drawn
