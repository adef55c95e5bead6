"""Device time of the traced batches' kernels and copies a batch
(torch.profiler; each kernel at its mean time times its launches a batch),
in ms."""
from portbench import devtrace


def read(obs):
    tr = obs["trace"]
    if tr is None or not tr["batches"] or not tr["kernels"]:
        return None
    return devtrace.per_call(tr["kernels"], tr["batches"]) * 1e3
