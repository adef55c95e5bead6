"""The program's counters ``ivf.signatures`` over ``ivf.batches`` (the
``vector_index`` registry, over the whole process: the warm-up runs the
cell's own batch shape): distinct probe signatures a batch.  Read in a
traced run; None where the program keeps no such counters."""
from repro_torch.obs.metrics import global_snapshot


def read(obs):
    if obs["trace"] is None or not obs["trace"]["kernels"]:
        return None
    for reg in global_snapshot():
        if reg["namespace"] == "vector_index":
            c = reg["counters"]
            batches = c.get("ivf.batches", 0)
            return c["ivf.signatures"] / batches if batches else None
    return None
