"""gcn-cora [gnn] n_layers=2 d_hidden=16 aggregator=mean norm=sym.

[arXiv:1609.02907; paper]
"""
from repro_torch.configs.base import ArchSpec, GNNConfig, gnn_shapes

ARCH = ArchSpec(
    name="gcn-cora",
    family="gnn",
    model=GNNConfig(
        kind="gcn",
        n_layers=2,
        d_hidden=16,
        aggregator="mean",
        norm="sym",
        n_classes=7,
    ),
    shapes=gnn_shapes(),
    source="arXiv:1609.02907; paper",
)
