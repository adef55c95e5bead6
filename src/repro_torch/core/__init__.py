"""PandaDB core: data model, CypherPlus, cost-based optimizer, executor,
driver-style sessions, semantic cache, vector index, AIPM extractor protocol."""
from repro_torch.core.property_graph import PandaGraph  # noqa: F401
from repro_torch.core.cypherplus import parse_query  # noqa: F401
from repro_torch.core.database import PandaDB  # noqa: F401
from repro_torch.core.session import (  # noqa: F401
    Cursor,
    PlanCache,
    PreparedStatement,
    Session,
)
