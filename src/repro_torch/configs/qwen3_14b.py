"""qwen3-14b [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.

qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].
"""
from repro_torch.configs.base import ArchSpec, TransformerConfig, lm_shapes

ARCH = ArchSpec(
    name="qwen3-14b",
    family="lm",
    model=TransformerConfig(
        n_layers=40,
        d_model=5_120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17_408,
        vocab_size=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        fsdp=True,
        grad_accum=4,
    ),
    shapes=lm_shapes(),
    source="hf:Qwen/Qwen3-8B; hf",
)
