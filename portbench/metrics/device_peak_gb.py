"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GB (1e9 bytes)."""


def read(obs):
    peak = obs["peak_window_bytes"]
    return peak / 1e9 if peak else None
