"""The work of one φ call of Mellum2-12B-A2.5B, from the configuration
file's published keys alone (nothing of the program is read).

FLOPs count the matrix products a token needs, 2 a multiply-add: the
q, k, v and output projections of GQA; QK^T and PV over the (query, key)
pairs each layer's attention weighs (:func:`attention_pairs`: the causal
half on a full layer, the band of ``sliding_window`` keys on a sliding
one); each MoE layer's router and every token through its
``num_experts_per_tok`` experts; the LM head over the whole vocabulary.
Embedding lookups, norms, RoPE, softmaxes and the gate count 0.  ``mfu``
divides them by the window and the card's dense bf16 peak
(``phi_work.PEAK_FLOPS_BF16``).

:func:`attn_least_s` is the least time of one call's attention launches
of a kind: each launch's band FLOPs at the bf16 peak or its q, k, v and
output bytes (bf16, each read or written once) at 3.35 TB/s, the larger
(NVIDIA's data sheet, H100 SXM at 700 W).
"""
from __future__ import annotations

from portbench.phi_work import PEAK_FLOPS_BF16

PEAK_BYTES = 3.35e12
KINDS = {"window": "sliding_attention", "full": "full_attention"}


def attention_pairs(cfg: dict, kind: str, seq: int) -> int:
    """(query, key) pairs one head of one sequence of ``seq`` tokens weighs
    on a layer of ``kind`` ("window" or "full"): min(p + 1, w) keys at
    position p under a band of w, p + 1 on a full layer."""
    if kind == "full" or seq <= cfg["sliding_window"]:
        return seq * (seq + 1) // 2
    w = cfg["sliding_window"]
    return w * (w + 1) // 2 + (seq - w) * w


def layers_of(cfg: dict, kind: str) -> int:
    return cfg["layer_types"].count(KINDS[kind])


def attention_flops(cfg: dict, kind: str, rows: int, seq: int) -> float:
    """FLOPs of one call's attention on the layers of ``kind``: QK^T and
    PV, 2 (D + Dv) a weighed pair and head."""
    return 2.0 * 2 * cfg["head_dim"] * cfg["num_attention_heads"] * rows \
        * attention_pairs(cfg, kind, seq) * layers_of(cfg, kind)


def call_flops(cfg: dict, rows: int, seq: int) -> float:
    """FLOPs of one φ call of ``rows`` texts of ``seq`` tokens."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    if any(t != "sparse" for t in cfg["mlp_layer_types"]):
        raise ValueError("mellum2_work: dense layers are not counted")
    proj = d * h * hd + 2 * d * kvh * hd + h * hd * d
    moe = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d \
        * cfg["moe_intermediate_size"]
    token = 2.0 * (cfg["num_hidden_layers"] * (proj + moe)
                   + d * cfg["vocab_size"])
    return rows * seq * token + sum(attention_flops(cfg, kind, rows, seq)
                                    for kind in KINDS)


def attn_least_s(cfg: dict, kind: str, rows: int, seq: int) -> float:
    """The least time of one call's attention launches on the layers of
    ``kind``, one launch a layer."""
    n = layers_of(cfg, kind)
    if not n:
        return 0.0
    width = 2 * cfg["head_dim"]                       # D + Dv
    n_bytes = 2.0 * rows * seq * width * (cfg["num_attention_heads"]
                                          + cfg["num_key_value_heads"])
    flops = attention_flops(cfg, kind, rows, seq) / n
    return n * max(flops / PEAK_FLOPS_BF16, n_bytes / PEAK_BYTES)
