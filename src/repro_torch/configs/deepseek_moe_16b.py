"""deepseek-moe-16b [moe] 28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400.

MoE 64e top-6, 2 shared + 64 routed, fine-grained [arXiv:2401.06066; hf].
Layer 0 is dense (d_ff = 10944 upstream; the assignment pins d_ff=1408 which is
the per-expert hidden -- we use 8*1408 for the first dense layer, the
fine-grained convention).
"""
from repro_torch.configs.base import ArchSpec, TransformerConfig, lm_shapes

ARCH = ArchSpec(
    name="deepseek-moe-16b",
    family="lm",
    model=TransformerConfig(
        n_layers=28,
        d_model=2_048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=8 * 1_408,          # first dense layer
        moe_d_ff=1_408,          # per-expert (fine-grained)
        vocab_size=102_400,
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        first_dense_layers=1,
        rope_theta=10_000.0,
        fsdp=True,
        grad_accum=2,
    ),
    shapes=lm_shapes(),
    source="arXiv:2401.06066; hf",
)
