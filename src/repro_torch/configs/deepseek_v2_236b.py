"""deepseek-v2-236b [moe] 60L d_model=5120 128H d_ff=1536 vocab=102400.

MoE 160e top-6, MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].  MLA: q_lora_rank=1536, qk_nope=128, qk_rope=64,
v_head=128.  First layer dense with d_ff=12288 (upstream convention).
"""
from repro_torch.configs.base import ArchSpec, TransformerConfig, lm_shapes

ARCH = ArchSpec(
    name="deepseek-v2-236b",
    family="lm",
    model=TransformerConfig(
        n_layers=60,
        d_model=5_120,
        n_heads=128,
        n_kv_heads=128,           # MLA: all heads share the latent KV
        d_ff=12_288,              # first dense layer
        moe_d_ff=1_536,           # per routed/shared expert
        vocab_size=102_400,
        n_routed_experts=160,
        n_shared_experts=2,
        top_k=6,
        first_dense_layers=1,
        kv_lora_rank=512,
        q_lora_rank=1_536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        fsdp=True,
        grad_accum=16,
    ),
    shapes=lm_shapes(),
    source="arXiv:2405.04434; hf",
)
