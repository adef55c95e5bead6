"""The window's φ FLOPs (``phi_work.call_flops`` a batch, from the
configuration file) over the window's seconds (host clock) and the card's
dense bf16 peak, 989 TFLOP/s, in %: the share of the whole step's peak."""
from portbench import phi_work


def read(obs):
    flops = obs.get("phi_flops")
    if not flops or obs["window_s"] <= 0:
        return None
    return 100.0 * flops / (obs["window_s"] * phi_work.PEAK_FLOPS_BF16)
