"""Device time of the kernels launched inside the program's
``phi.forward`` spans (torch.profiler: each range's kernels and its
children's) over the traced batches, in ms.  None where the program opens
no such span."""


def read(obs):
    tr = obs["trace"]
    if tr is None or not tr["batches"] or not tr.get("phi_device_s"):
        return None
    return 1e3 * tr["phi_device_s"] / tr["batches"]
