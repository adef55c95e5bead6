"""mellum2-12b-a2.5b [moe] 28L d_model=2304 32H (GQA kv=4) vocab=98304.

JetBrains' Mellum2-12B-A2.5B-Instruct at its published widths and depth
(https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct/blob/main/config.json):
GQA with 32 query and 4 key heads of 128, no attention bias, no qk-norm
(the config has no such key); ``layer_types`` three sliding-window layers
(``sliding_window`` 1,024) then one full layer, seven times over; the full
layers rotate with YaRN (theta 500,000, factor 16 over 8,192 positions,
beta 32 / 1, ``attention_factor`` 1.27726 = 0.1 ln 16 + 1), the sliding
ones with plain RoPE at theta 500,000; every layer a sparse MoE
(``mlp_layer_types``): 64 experts of 896, top 8 of a softmax gate,
renormalised (``norm_topk_prob``), no shared expert; RMSNorm eps 1e-6; an
untied head.  ``intermediate_size`` 7,168 is published beside
``mlp_layer_types`` but no layer is dense.

Served as PandaDB's document φ it routes dropless, as the published model
does at inference.  Outside the reference's registry: ``get_arch``
resolves it, no dry-run cell holds it.
"""
from repro_torch.configs.base import (ArchSpec, LMShape, TransformerConfig,
                                      YarnRope)

_KINDS = ("sliding_attention",) * 3 + ("full_attention",)

ARCH = ArchSpec(
    name="mellum2-12b-a2.5b",
    family="lm",
    model=TransformerConfig(
        n_layers=28,
        d_model=2_304,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=7_168,               # published; every layer is MoE
        moe_d_ff=896,
        vocab_size=98_304,
        n_routed_experts=64,
        n_shared_experts=0,
        top_k=8,
        first_dense_layers=0,
        rope_theta=500_000.0,
        rms_eps=1e-6,
        yarn=YarnRope(factor=16.0, original_max_position=8_192,
                      beta_fast=32.0, beta_slow=1.0,
                      attention_factor=1.2772588722239782),
        norm_topk_prob=True,
        dropless=True,
        layer_types=_KINDS * 7,
        sliding_window=1_024,
    ),
    # φ's batch: one report of 32,768 byte tokens, one forward
    shapes={"doc_b1_t32k": LMShape("doc_b1_t32k", seq_len=32_768,
                                   global_batch=1, kind="prefill")},
    source="hf JetBrains/Mellum2-12B-A2.5B-Instruct config.json",
)
