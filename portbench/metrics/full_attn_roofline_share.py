"""The least time of a traced batch's full-attention launches
(``mellum2_work.attn_least_s``: each full layer's causal FLOPs at 989
TFLOP/s or its q, k, v, o bytes at 3.35 TB/s, the larger; from the
configuration and the traffic) over their device time a batch: the flash
kernel's causal instantiation, which the program launches inside its
``lm.attn.full`` spans (torch.profiler; each kernel at its mean time times
its launches a batch), in %.  None where the trace holds no such
kernel."""
from portbench import devtrace


def read(obs):
    tr = obs["trace"]
    if tr is None or not tr["batches"] or not tr.get("attn_kernels"):
        return None
    secs = devtrace.per_call(tr["kernels"], tr["batches"],
                             tr["attn_kernels"]["full"])
    return 100.0 * obs["attn_least_s"]["full"] / secs if secs else None
