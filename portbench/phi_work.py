"""The work of one φ call of DeepSeek-V2-Lite, from the configuration
file's published keys alone (nothing of the program is read).

FLOPs count the matrix products a token needs, 2 a multiply-add: MLA's
projections (q without LoRA, the latent and rope key, the latent's
up-projection to k_nope and v, the output); QK^T and PV over the causal
half of each sequence (S^2 / 2 query-key pairs); the dense layers'
SwiGLU; each MoE layer's router, every token through its
``num_experts_per_tok`` routed experts and the shared experts; the LM
head over the whole vocabulary.  Embedding lookups, norms, softmaxes and
the gate count 0.  ``mfu`` divides them by the window and the card's
dense bf16 peak (NVIDIA's data sheet, H100 SXM at 700 W).
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12


def token_flops(cfg: dict, seq: int) -> float:
    """FLOPs a token at sequence length ``seq``."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, dc = cfg["v_head_dim"], cfg["kv_lora_rank"]
    if cfg.get("q_lora_rank"):
        raise ValueError("phi_work: q-LoRA is not counted")
    proj = d * h * (dn + dr) + d * (dc + dr) + dc * h * (dn + dv) \
        + h * dv * d
    # a token's share of the causal half: seq / 2 keys a query
    attn = h * (dn + dr + dv) * seq / 2
    layer_attn = 2.0 * (proj + attn)
    dense = 2.0 * 3 * d * cfg["intermediate_size"]
    f = cfg["moe_intermediate_size"]
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    moe = 2.0 * (d * cfg["n_routed_experts"] + experts * 3 * d * f)
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    head = 2.0 * d * cfg["vocab_size"]
    return cfg["num_hidden_layers"] * layer_attn + n_dense * dense \
        + n_moe * moe + head


def call_flops(cfg: dict, rows: int, seq: int) -> float:
    """FLOPs of one φ call of ``rows`` texts of ``seq`` tokens."""
    return rows * seq * token_flops(cfg, seq)
