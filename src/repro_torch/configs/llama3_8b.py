"""llama3-8b [dense] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA 128k vocab [arXiv:2407.21783; unverified].
"""
from repro_torch.configs.base import ArchSpec, TransformerConfig, lm_shapes

ARCH = ArchSpec(
    name="llama3-8b",
    family="lm",
    model=TransformerConfig(
        n_layers=32,
        d_model=4_096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        vocab_size=128_256,
        rope_theta=500_000.0,
        fsdp=True,
        grad_accum=4,
    ),
    shapes=lm_shapes(),
    source="arXiv:2407.21783; unverified",
)
