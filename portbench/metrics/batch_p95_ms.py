"""95th percentile of every batch's latency in the window, from the call
to its return with the answers on the host (host clock), in ms."""
import numpy as np


def read(obs):
    lat = obs["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
