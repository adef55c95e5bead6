"""gat (BONUS arch from the public pool) [arXiv:1710.10903]:
8-head graph attention, the SDDMM/edge-softmax kernel regime.
Not part of the assigned 40-cell grid; selectable via --arch gat-bonus."""
from repro_torch.configs.base import ArchSpec, GNNConfig, gnn_shapes

ARCH = ArchSpec(
    name="gat-bonus",
    family="gnn",
    model=GNNConfig(kind="gat", n_layers=2, d_hidden=8, n_heads=8,
                    n_classes=7),
    shapes=gnn_shapes(),
    source="arXiv:1710.10903; paper (bonus)",
)
