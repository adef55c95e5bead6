"""Sharding rules and collectives over ``torch.distributed``."""
from repro_torch.distributed.sharding import (  # noqa: F401
    LOGICAL_RULES,
    ShardingRules,
    logical_spec,
    logical_sharding,
    constrain,
)
