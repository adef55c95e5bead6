"""The port's deployment configs: PandaDB's own knobs.  The model registry
of the reference's ``configs`` package comes with the model slice."""
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
