"""The share of the window's traced slice in which no kernel or copy runs
on the device (torch.profiler), in %."""


def read(obs):
    tr = obs["trace"]
    if tr is None or tr["window_s"] <= 0 or not tr["kernels"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
