"""The card idle while the host runs the vector index's own code: the
traced slice's idle gaps named by an ``ivf.*`` span of ``search_many``
(the innermost host range at the gap's middle, so no torch operator ran
there), over the slice's length (torch.profiler), in %.  None where the
program opens no such spans."""
from repro_torch.obs.metrics import global_snapshot


def read(obs):
    tr = obs["trace"]
    if tr is None or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    if not any(r["namespace"] == "vector_index" for r in global_snapshot()):
        return None
    idle = sum(secs for name, secs in tr["idle_gaps"]
               if name.startswith("ivf."))
    return 100.0 * idle / tr["window_s"]
