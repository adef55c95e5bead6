"""schnet [gnn] n_interactions=3 d_hidden=64 rbf=300 cutoff=10.

[arXiv:1706.08566; paper]
"""
from repro_torch.configs.base import ArchSpec, GNNConfig, gnn_shapes

ARCH = ArchSpec(
    name="schnet",
    family="gnn",
    model=GNNConfig(
        kind="schnet",
        n_layers=3,
        d_hidden=64,
        n_rbf=300,
        cutoff=10.0,
    ),
    shapes=gnn_shapes(),
    source="arXiv:1706.08566; paper",
)
