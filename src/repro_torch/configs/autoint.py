"""autoint [recsys] n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2 d_attn=32.

interaction=self-attn [arXiv:1810.11921; paper].  39 sparse fields = Criteo's
13 dense-as-bucketized + 26 categorical convention.
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, recsys_shapes

ARCH = ArchSpec(
    name="autoint",
    family="recsys",
    model=RecsysConfig(
        kind="autoint",
        n_sparse=39,
        embed_dim=16,
        n_attn_layers=3,
        n_heads=2,
        d_attn=32,
        vocab_per_field=1_000_000,
        multi_hot=4,
    ),
    shapes=recsys_shapes(),
    source="arXiv:1810.11921; paper",
)
