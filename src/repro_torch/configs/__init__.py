"""The port's configs: PandaDB's own knobs, the model dataclasses of
``configs/base.py``, and the architecture registry.

``get_arch("llama3-8b")`` resolves an :class:`ArchSpec`.  The registry
holds the five transformer architectures of the reference's registry, all
of which the port's LM runs (dense GQA, qk-norm, DeepSeekMoE, MLA), and its
six GNN architectures (GCN, GraphSAGE, SchNet, Equiformer-v2 and the bonus
GAT and GIN).  The recsys architecture, and with it the reference's
``ASSIGNED`` list and ``all_cells``, comes with its modules (ROADMAP
Queue A)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    ArchSpec,
    GNNConfig,
    GraphShape,
    TransformerConfig,
    gnn_shapes,
    reduced,
)
from repro_torch.configs.pandadb import (  # noqa: F401 (re-export)
    DEFAULT,
    AIPMConfig,
    BlobStoreConfig,
    CacheConfig,
    CascadeConfig,
    ClusterConfig,
    CostModelConfig,
    ObsConfig,
    PandaDBConfig,
    ServingConfig,
    VectorIndexConfig,
)

_ARCH_MODULES = {
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "schnet": "repro_torch.configs.schnet",
    # bonus archs from the public pool (not in the assigned cell grid)
    "gat-bonus": "repro_torch.configs.gat_bonus",
    "gin-bonus": "repro_torch.configs.gin_bonus",
}


def arch_names() -> List[str]:
    return list(_ARCH_MODULES)


def get_arch(name: str) -> ArchSpec:
    try:
        mod = importlib.import_module(_ARCH_MODULES[name])
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}") from None
    return mod.ARCH
