"""The traced batches' least time over the device time of ``ivf_scan``'s
kernels (torch.profiler), in %: its norms and scoring, its radix select
and the survivors' stable sort.  The probe's sort of [Q, buckets] runs the same
sort kernel and is counted with it."""
from portbench import devtrace

KERNELS = ("ivf_norms", "ivf_score", "radix_select", "radixSortKVInPlace")


def read(obs):
    tr = obs["trace"]
    if tr is None or not tr["batches"]:
        return None
    secs = devtrace.per_call(tr["kernels"], tr["batches"], KERNELS)
    if not any(k in name for name, _, _ in tr["kernels"]
               for k in KERNELS[:2]):
        return None
    return 100.0 * tr["least_s"] / tr["batches"] / secs
