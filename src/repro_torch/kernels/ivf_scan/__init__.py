from repro_torch.kernels.ivf_scan.ops import ivf_scan_topk  # noqa: F401
