"""The program's counters ``ivf.h2d_bytes`` plus ``ivf.d2h_bytes`` over
``ivf.queries`` (the ``vector_index`` registry, over the whole process:
the warm-up runs the cell's own batch shape): bytes ``search_many``
copies between host and device a query.  Read in a traced run; None
where the program keeps no such counters."""
from repro_torch.obs.metrics import global_snapshot


def read(obs):
    if obs["trace"] is None or not obs["trace"]["kernels"]:
        return None
    for reg in global_snapshot():
        if reg["namespace"] == "vector_index":
            c = reg["counters"]
            queries = c.get("ivf.queries", 0)
            return ((c["ivf.h2d_bytes"] + c["ivf.d2h_bytes"]) / queries
                    if queries else None)
    return None
