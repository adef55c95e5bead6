"""stablelm-12b [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b; hf] -- dims follow the assignment exactly.
StableLM-2 uses partial rotary embeddings upstream; we use full rotary with
theta=10k (assignment gives no rotary spec) and note it here.
"""
from repro_torch.configs.base import ArchSpec, TransformerConfig, lm_shapes

ARCH = ArchSpec(
    name="stablelm-12b",
    family="lm",
    model=TransformerConfig(
        n_layers=40,
        d_model=5_120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,  # d_model / n_heads
        d_ff=13_824,
        vocab_size=100_352,
        rope_theta=10_000.0,
        fsdp=True,
        grad_accum=4,
    ),
    shapes=lm_shapes(),
    source="hf:stabilityai/stablelm-2-1_6b; hf",
)
