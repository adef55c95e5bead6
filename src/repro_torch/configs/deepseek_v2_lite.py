"""deepseek-v2-lite [moe] 27L d_model=2048 16H d_ff=10944 vocab=102400.

DeepSeek-V2-Lite at its published widths and depth
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json;
arXiv:2405.04434): MLA with kv_lora_rank=512 and no q-LoRA (qk_nope=128,
qk_rope=64, v_head=128), YaRN RoPE (factor 40 over 4,096 positions); layer
0 dense with d_ff=10944, then 26 MoE layers of 64 routed experts (1408
wide) and 2 shared, top-6 of a softmax gate, greedy, weights not
renormalised (its routed_scaling_factor is 1: the gate as
it is); RMSNorm eps 1e-6; untied head.

Served as PandaDB's text φ, it routes dropless: a query's zero padding
(token 0 at every padded position) routes nearly as one token and would
fill six experts' capacity, so per-row capacity would drop real tokens
and make a query's vector depend on its length.  The published model
drops nothing at inference.  Outside the reference's registry (its
``arch_names`` and the 40 cells are the reference's), so ``get_arch``
resolves it but no dry-run cell holds it.
"""
from repro_torch.configs.base import (ArchSpec, LMShape, TransformerConfig,
                                      YarnRope)

ARCH = ArchSpec(
    name="deepseek-v2-lite",
    family="lm",
    model=TransformerConfig(
        n_layers=27,
        d_model=2_048,
        n_heads=16,
        n_kv_heads=16,            # MLA: all heads share the latent KV
        d_ff=10_944,              # the dense first layer
        moe_d_ff=1_408,           # per routed/shared expert
        vocab_size=102_400,
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        first_dense_layers=1,
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        rms_eps=1e-6,
        yarn=YarnRope(factor=40.0, original_max_position=4_096,
                      beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                      mscale_all_dim=0.707),
        norm_topk_prob=False,
        dropless=True,
    ),
    # φ's batch: 256 query texts of 64 byte tokens (the AIPM protocol's
    # max_batch), one forward
    shapes={"phi_q256_t64": LMShape("phi_q256_t64", seq_len=64,
                                    global_batch=256, kind="prefill")},
    source="arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite",
)
