"""The window's least time (``roofline.knn_work``: its batches' FLOPs at
67 TFLOP/s or bytes at 3.35 TB/s, the larger) over its measured length
(host clock), in %."""


def read(obs):
    least = obs["work"]["least_s"]
    return 100.0 * least / obs["window_s"] if least > 0 else None
