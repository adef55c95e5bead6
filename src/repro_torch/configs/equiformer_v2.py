"""equiformer-v2 [gnn] n_layers=12 d_hidden=128 l_max=6 m_max=2 n_heads=8.

Equivariant graph-attention via eSCN SO(2) convolutions [arXiv:2306.12059].
"""
from repro_torch.configs.base import ArchSpec, GNNConfig, gnn_shapes

ARCH = ArchSpec(
    name="equiformer-v2",
    family="gnn",
    model=GNNConfig(
        kind="equiformer_v2",
        n_layers=12,
        d_hidden=128,
        l_max=6,
        m_max=2,
        n_heads=8,
        n_rbf=128,
        cutoff=12.0,
    ),
    shapes=gnn_shapes(),
    source="arXiv:2306.12059; unverified",
)
