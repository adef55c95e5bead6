"""graphsage-reddit [gnn] n_layers=2 d_hidden=128 aggregator=mean sample_sizes=25-10.

[arXiv:1706.02216; paper]
"""
from repro_torch.configs.base import ArchSpec, GNNConfig, gnn_shapes

ARCH = ArchSpec(
    name="graphsage-reddit",
    family="gnn",
    model=GNNConfig(
        kind="graphsage",
        n_layers=2,
        d_hidden=128,
        aggregator="mean",
        sample_sizes=(25, 10),
    ),
    shapes=gnn_shapes(),
    source="arXiv:1706.02216; paper",
)
