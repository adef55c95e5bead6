"""The port's configs: PandaDB's own knobs, the model dataclasses of
``configs/base.py``, and the architecture registry.

``get_arch("llama3-8b")`` resolves an :class:`ArchSpec`.  The registry
holds every architecture of the reference's registry: the five transformer
architectures, all of which the port's LM runs (dense GQA, qk-norm,
DeepSeekMoE, MLA), the six GNN architectures (GCN, GraphSAGE, SchNet,
Equiformer-v2 and the bonus GAT and GIN) and the recsys AutoInt.
``all_cells`` lists every assigned (arch, shape) pair, the reference's 40
cells in its order."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    ArchSpec,
    GNNConfig,
    GraphShape,
    LMShape,
    RecsysConfig,
    RecsysShape,
    TransformerConfig,
    gnn_shapes,
    lm_shapes,
    recsys_shapes,
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
    "autoint": "repro_torch.configs.autoint",
    # bonus archs from the public pool (not in the assigned 40-cell grid)
    "gat-bonus": "repro_torch.configs.gat_bonus",
    "gin-bonus": "repro_torch.configs.gin_bonus",
}

ASSIGNED = [n for n in _ARCH_MODULES if not n.endswith("-bonus")]

#: the port's own architectures, outside the reference's registry: ``get_arch``
#: resolves them, ``arch_names`` and ``all_cells`` leave them out
_PORT_MODULES = {
    "deepseek-v2-lite": "repro_torch.configs.deepseek_v2_lite",
    "mellum2-12b-a2.5b": "repro_torch.configs.mellum2_12b_a2_5b",
}


def arch_names() -> List[str]:
    return list(_ARCH_MODULES)


def get_arch(name: str) -> ArchSpec:
    modules = {**_ARCH_MODULES, **_PORT_MODULES}
    try:
        mod = importlib.import_module(modules[name])
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(modules)}") from None
    return mod.ARCH


def all_cells() -> List[tuple]:
    """Every ASSIGNED (arch, shape) pair: the 40 cells."""
    return [(name, shape) for name in ASSIGNED
            for shape in get_arch(name).shapes]
