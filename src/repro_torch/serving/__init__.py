from repro_torch.serving.engine import QueryServer, ServeStats  # noqa: F401
