"""gin (BONUS arch from the public pool) [arXiv:1810.00826]:
sum-aggregation + eps + MLP.  Selectable via --arch gin-bonus."""
from repro_torch.configs.base import ArchSpec, GNNConfig, gnn_shapes

ARCH = ArchSpec(
    name="gin-bonus",
    family="gnn",
    model=GNNConfig(kind="gin", n_layers=5, d_hidden=64, n_classes=7),
    shapes=gnn_shapes(),
    source="arXiv:1810.00826; paper (bonus)",
)
